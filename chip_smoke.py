#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (bfsr_tpu_torch) on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's three main paths and its five trainers at their full
configurations, random weights from seed 0 — LINF-LP learned-prior inference
(EDSR-baseline 16x64 encoder, 10-layer pointwise flow, 256-wide info MLP,
UNet depth 3 / dim 64), its patch model (``bench.py``'s patch workload:
ps = 3, d = 27, info MLP out 540, UNet in_chans 27) and SRFlow-LP
learned-prior inference
(``configs/srflow/SRFlow-LP_DF2K_4X.yml``: RRDB 64 x 23, Glow pyramid
K 16 / L 3 / hidden 64, two-branch UNet prior depth 3 / dim 64) — and
fails (non-zero exit, no result line) if any phase fails:

1. a CUDA device must be present; prints the card's name and power limit;
2. builds every kernel from ``bfsr_tpu_torch/csrc`` (prints the seconds),
   then runs phase 18, the native host library, before phase 3;
3. holds each kernel against its plain PyTorch twin on the card at the
   main path's shapes (K1 forward/inverse, K2 at 128^2 -> 512^2 and a
   ragged shape, K3 at the encoder's and the UNet's full-resolution
   convs), printing the max abs error beside its tolerance and both times;
4. runs ``LINFPredictor.predict`` with the prior at LR 128x128 -> HR
   512x512 (the ``bench.py`` workload, inputs from
   ``np.random.default_rng(0)``) with every launch counter reset first:
   the output must be finite, every kernel must have launched, and the
   image must agree with the same predictor run through the twins; then
   again at the ragged LR 96x80 -> HR 300x250;
5. times the kernel path and the twin path (2 warm-ups, 3 blocks of 5
   predicts each, synchronised) and prints median/best ms per image, HR
   MP/s, and a per-kernel device-time profile of one kernel-path predict;
6. LINF-LP patch model: holds K4 (forward and inverse, d = 27, L = 10) and
   K2 at out_dim 540 against their twins at the 172^2 centre grid of LR
   128^2 -> HR 516^2 and at the 135x114 grid of the ragged LR 101x85 ->
   HR 404x340 (the patch wrapper's padded grid), runs
   ``LINFPredictor.predict`` at both with the launch counters reset (K4
   once each way, K2 once, K3 43 times; the folded image finite, of shape
   (1, 3 Hq, 3 Wq, 3) and within 5e-4 of the twin path), times both paths,
   profiles one 516^2 predict (K4's time in it), and runs ``eval_psnr``
   over two in-memory pairs through the ``sr-implicit-paired-fast-patch``
   wrapper on both paths (PSNRs finite and within 0.01 dB);
7. SRFlow-LP: holds K5 (forward and reverse) against its twin at each
   flow level's shape of a 512^2 image and K3 at two RRDB dense-block convs
   (conv4, 4 inputs, 160 -> 32, and conv5, 5 inputs, 192 -> 64, at 128^2;
   conv1-4's Cout-32 shape has the most launches of any K3 shape), then
   runs ``SRFlowLPPredictor.predict`` at LR 128x128 -> HR 512x512 and at
   the ragged LR 101x85 (padded to 102x86, cropped back to 404x340) with
   the launch counters reset first:
   the output must be finite and of the right shape, K5 must have
   launched 48 times each way and K3 at all, and the image must agree with
   the twin path; then times both paths and profiles one 512^2 predict,
   split into its stages (RRDB, precompute_ft, encode, prior, decode);
8. the bf16 serving modes (``BFSR_PRECISION=mixed|default``): holds the
   bf16 K3 (``csrc/conv3x3_bf16.cu``) against its twin at the encoder's
   conv, ``dense5c`` and the last ``up`` conv (beside cuDNN bf16 and its
   bf16 bound), K6 (``conv3x3_fused``) at 64 -> 64 @512^2 and a ragged
   Cout of 100, and runs the conv probe (P1-P3, ``profiling/conv_probe``);
   then runs LINF-LP ``predict`` under ``mixed`` and ``default`` at both
   shapes with the launch counters reset (the bf16 K3 9 / 43 times, the
   f32 K3 34 / 0, K1 and K2 once each), each image against the twin path
   in the same mode and its agreement (PSNR) with ``high``'s output, times
   ``high``, ``mixed`` and ``default`` interleaved and profiles both
   modes; and SRFlow-LP under ``mixed`` (the bf16 K3 only in the prior,
   18 times; K5 48 + 48 in f32) and its agreement beside ``high``;
9. SRFlow-LP under ``default`` (every stage bf16): holds both of K5's
   one-pass forms (``csrc/flow_step_bf16.cu``, forward and reverse; the
   served ``xla`` form, which keeps the folds f32 as the JAX predictor's
   XLA step does, and the ``pallas`` form, which rounds all five operands
   as the JAX FlowStep kernel does) against their twins at each flow
   level's shape of a 512^2 image, with their bf16 bound, and the bf16 K3
   at the two RRDB convs; then runs ``predict`` at 512^2 and at the ragged
   101x85 with the launch counters reset (the bf16 K3 363 times, the f32
   K3 0, the served one-pass K5 48 + 48, the f32 K5 0): the image finite,
   within a PSNR floor of the twin path in the same mode, and its
   agreement with ``high`` at or above its floor; runs the ``pallas`` form
   through its own entry (the flow frozen with ``step_form="pallas"``, one
   512^2 predict: its K5 48 + 48, its agreement with ``high`` beside the
   served form's); times ``high``, ``mixed`` and ``default`` interleaved at
   both shapes, splits ``mixed`` and ``default`` into stages and profiles
   one ``default`` predict;
10. the LINF-LP trainer (``configs/train/train_edsr-baseline-linf-LP.yaml``:
   the LINF-LP models above, VGG19 through conv5_4, Adam at 1e-4, batch
   16 of 48^2 LR crops, each at its own scale from U(1, 4)), on synthetic
   batches from ``np.random.default_rng`` in the crop wrapper's layout
   (smooth random HR images, downsampled bilinearly: no PIL) and a VGG
   drawn He-normal (no weights ship with the repository): holds the
   batched K3 in f32 and bf16 (the encoder's 64 -> 64 and head 3 -> 64
   convs at B = 16, 48^2, beside cuDNN) and the batched K2 (per-sample axes and cells, out
   60) against their twins, and K1 inverse's gradient (``FlowInverse``)
   against autograd through the twin; takes one step's loss and gradients
   on the kernel path and on the twin path from the same state, with the
   launch counters reset (K3 34, K2 1, K1 1 + 1; K1 forward 2 with the
   latent loss, a second check): the losses within 1e-5 relative, each
   gradient tensor, and all as one vector, within twice the twin path's
   own spread under a 1e-7 nudge of its input, in relative L2, at most
   0.5 (``TRAIN_TOL``); runs 20 steps (finite
   losses, every parameter moved; the first and last loss printed, not
   gated: the VGG is random); times steps on resident batches (kernel and
   twin paths interleaved) and fed by the port's ``DataLoader`` (the
   samples' residuals from the native host library, then from its numpy
   twin, each beside the resident rate), splits a step into its stages,
   profiles one and prints its peak memory;
11. the LINF-LP patch trainer (``train.py --patch 3``: the patch model of
   phase 6, its UNet at in_chans 27, the VGG19 and Adam of phase 10) on
   batches of 16 synthetic samples in the crop-patch wrapper's layout (LR
   crops of 144^2, 48^2 patch centres, HR windows of 144^2): holds K3 in
   f32 and bf16 at B = 16 over the 144^2 crops (the encoder's 64 -> 64 and
   the head's 3 -> 64, beside cuDNN), K2 at out 540 over the 16 crops'
   centre grids and K4 both ways at N = 36,864 (d = 27) against their
   twins, and ``FlowInverse``'s gradient at d = 27 against autograd
   through the twin; one step's loss and gradients on both paths with the
   launch counters reset (K3 34, K2 1, K4 1 + 1; K4 forward 2 with the
   latent loss, a second check; K1 0), held as phase 10 holds them; 20
   steps, steps/s resident and loader-fed (native residual and numpy
   twin, as phase 10), the stage split, a profile and peak memory; then
   both trainers under ``mixed`` and ``default``: one
   step each with the counters reset (the encoder's 34 convs on the f32 K3
   under ``mixed``, on the bf16 K3 under ``default``), its frozen part
   held launch by launch against the twins on the step's own values (each
   kernel's own tolerance), its trainable part on both paths from those
   values (``MODE_TRAIN_TOL``), its loss against ``high``'s on the same
   batch; and ``high``, ``mixed`` and ``default`` steps timed
   interleaved;
12. the SRFlow-LP prior trainer (``srflow_train.py --prior`` on
   ``configs/srflow/SRFlow-LP_DF2K_4X.yml``: the flow and prior of phase
   7, the flow frozen, Adam at 2.5e-4 with its MultiStepLR, batch 12 of
   160^2 GT crops with 40^2 LQ, the eps loss) on synthetic batches in the
   ``lrhr-pkl`` layout (smooth random HR, LQ by a 4x4 area mean): holds K5
   at B = 12 at the three level shapes (80^2 x 12, 40^2 x 24, 20^2 x 96),
   f32 and the served one-pass form, forward and reverse, and
   ``FlowStepReverse``'s gradient against autograd through the twin, and
   both K3s at the RRDB's conv4 and conv5 at B 12 @40^2 beside cuDNN; one
   step's loss and gradients on both paths (K3 345, K5 96 forward; with
   the image loss, a second check, K5 48 reverse too), held as phase 10
   holds them, the spread the larger under LQ x (1 +- 1e-7); 20 steps
   (finite, every parameter moved, peak memory); steps/s resident (twin,
   kernel, kernel with the image loss, interleaved) and fed by the
   port's ``DataLoader`` over
   ``lrhr-pkl`` pickles written to a temporary directory; the stage split
   (RRDB, conditioning records, LR encode, prior, GT encode, decode,
   backward, update) and profiles; then one step each under ``mixed`` and
   ``default`` with the image loss (``default``: the bf16 K3 345, the
   one-pass K5 96 + 48), held as phase 11 holds the LINF modes, the
   three modes timed interleaved, ``mixed`` and ``default`` split into
   stages and a ``default`` step profiled;
13. the evaluation entry points, in-process, on data the phase writes to
   a temporary directory (smooth random HR PNGs of 256x192 from
   ``np.random.default_rng``, their x4 LR by PIL bicubic, a val folder)
   and the flagship models saved as port checkpoints (random weights,
   seed 0), each launch counted per image or batch (``EVAL_LAUNCHES``):
   (a) the ``test.py`` twin (``bfsr_tpu_torch/cli/test.py``) on copies
   of the three shipped ``configs/test/*.yaml`` with their paths
   rewritten, 2 images each, kernel path against twin path (PSNR within
   ``TOL['eval_psnr_db']``, the first pair's predict image by image
   within ``TOL['image']``), then ``--detail`` with a random LPIPS file,
   ``--randomness --temperature 0.8`` without a prior (diversity > 0),
   ``--sample 1`` (the PNG written), ``--window 8`` and ``--patch`` on
   the patch model through ``sr-implicit-downsampled-fast-patch-test``;
   one DIV2K-size frame (HR 2040x1356, LR 510x339) on both paths (PSNR,
   and the image within ``TOL['image']``), its ms per image, HR MP/s and
   peak memory, and ``cli/test.py``'s seconds for it with the residual
   from the native host library and from its numpy twin (PSNRs within
   ``TOL['eval_psnr_db']``); (b) validation: ``eval_psnr`` over 2 batches of 16 val
   crops (``sr-implicit-downsampled-fast`` at ``inp_size`` 48), each
   query at its own coordinate, on both paths (PSNR, and the first
   batch's images within ``TOL['image']``), the seconds a batch; one
   ``cli/train.py`` epoch with ``epoch_val: 1``,
   whose ``val: psnr=`` must be finite; (c) the ``srflow_test.py`` twin
   (``bfsr_tpu_torch/cli/srflow_test.py``) on the LR / HR pairs with the
   flagship SRFlow-LP conf, paths rewritten, on both paths (PSNR and LRC
   PSNR within ``TOL['eval_psnr_db']``, SSIM within ``TOL['eval_ssim']``;
   the CSV's 2 rows of 6 columns; the first LR's predict held as phase
   7 holds SRFlow-LP's, within ``TOL['srflow_image']``).  It prints the phase's seconds, and
   the run's seconds in all;
14. SRFlow base-model training (``srflow_train.py`` without ``--prior`` on
   ``configs/srflow/SRFlow-LP_DF2K_4X.yml``: the SRFlow-LP flow at full
   width and depth, random weights from seed 0, its actnorms primed on
   the first of 4 synthetic batches of 12 x 160^2 GT, Adam at 2.5e-4 over
   every parameter, the NLL): one frozen-phase step with the launch
   counters reset (K3 345 on the frozen RRDB, no K5: the trained flow runs
   unfused), its RRDB held launch by launch against the twins, its loss
   and every gradient against the twin path's, held as phase 12 holds its
   step; the live step at the same weights, batch and noise (no kernel;
   its loss and the flow's gradients within the same spread of the frozen
   twin step's; the RRDB's conditioning on K3 against cuDNN within
   ``BASE_TOL['rrdb_cudnn_rel']``); a frozen step under ``default`` (the
   bf16 K3 345, held launch by launch, loss finite); ms/step of both
   phases (3 blocks x 5 steps), their stages, profiles and peak memory, a
   loader-fed block over ``lrhr-pkl`` pickles, one live step that moves
   every RRDB tensor but the unread x4 head; ``validate`` on 2 val pairs
   at heats (0, 0.5, 0.75, 1) x 3 samples (K3 345, K5 576 reverse; the
   heat-0 images within ``TOL['srflow_image']`` and the NLL within
   ``BASE_TOL['nll_rel']`` of the twin path's); and the RRDB's plain-SR
   trainer (the x4 RRDB at 64 x 23, B 16 of 32^2 LQ, Charbonnier: no
   kernel, losses finite, ms/step, peak memory).  It prints the phase's
   seconds;
15. LINF-LP's other encoders and latent modules (``run_other_encoders``):
   (A) the RRDB-encoder LINF of ``configs/train/train_rrdb-linf-LP.yaml``
   (RRDB 64 x 23, gc 32, the flagship's flow, MLP and UNet): the encoder's
   345 K3 launches each against its twin on its own input, K3 at its
   conv4 / conv5 at 128^2 and at B 16 @48^2 beside cuDNN, the 128^2 ->
   512^2 predict against the twin path (K3 354, K2 1, K1 1 + 1), timed
   and profiled, under ``mixed`` (LINF-LP's floors) and ``default``
   (``RRDB_DEFAULT``), and one trainer step (K3 345; the whole step's loss
   against the twin path's, the frozen part launch by launch, the
   trainable part within the twin's spread), ms/step, profile, peak
   memory; (B) the flagship with the ``swin_latent`` prior: the predict
   against the twin path (K3 34), timed and profiled, the cuDNN times of
   the 96-wide dense convs no K3 takes, and one step with stochastic depth
   on both paths from the same generator state, held as phase 12 holds
   its step (the twin's spread the larger under gt_lr_up x (1 +- 1e-7));
   a loader-fed ``cli/train.py`` epoch of
   ``train_rrdb-linf-LP.yaml`` as shipped over DF2K-size PNGs it writes
   (K3 345 a step); the SwinIR- and RDN-encoder LINFs and the flagship
   with ``edsr-baseline-latent`` (K3 34 + 42), each predict against the
   twin path and timed, and the full EDSR's 256-wide conv on cuDNN.  It
   prints the phase's seconds;
16. SRFlow at 8x (``run_srflow_x8``): the model of
   ``bfsr_tpu_torch/configs/srflow_df2k_8x.yml`` (RRDB 64 x 23, K 16, L 4,
   hidden 64; 64 conditional steps at C = 12, 24, 48 and 192): K5 f32 and
   both one-pass forms, forward and reverse, against their twins at each
   level of the 512^2 sample (256^2 x 12, 128^2 x 24, 64^2 x 48, 32^2 x
   192) and of the trainer's B 12 (80^2 x 12 ... 10^2 x 192); ``sample_sr``
   at LR 64^2 -> 512^2 and 50x42 -> 400x336, heat 0 and 0.8 (a seeded
   generator), under ``high`` and ``default``, each with the launch
   counters reset first (K3 345 and K5's reverse 64, the bf16 K3 and the
   served one-pass K5 under ``default``) and against the twin path
   (``TOL['srflow_image']`` / ``TOL['srflow_default_twin_db']``); ms per
   image, HR MP/s, the stages (RRDB, records, decode), peak memory and a
   profile; the base trainer at B 12 of 160^2 GT (a frozen step, K3 345,
   and a live step, held as phase 14 holds them), ``validate`` on 2 pairs
   on those primed weights (K3 345, K5 768 reverse), then the two steps
   timed (ms/step, peak memory).  It prints the phase's seconds;
17. SRFlow at 16x (``run_srflow_x16``: ``bfsr_tpu_torch/configs/
   srflow_df2k_16x.yml``, the 8x model's widths at scale 16, K5 at C = 12,
   24, 48 and 192 on the 8x sample's level shapes): ``sample_sr`` at LR
   32^2 -> 512^2 and 25x21 -> 400x336, heat 0 and 0.8, in high and
   default, held as phase 16 holds the 8x sample (K3 345 and K5 64
   reverse a sample); ms per image, HR MP/s, stages, idle share, peak
   memory; ``validate`` on the primed weights; the base step at B 12 of
   160^2 GT over 10^2 LQ frozen and live, as phase 14 holds them.  Then
   the sharded steps and predicts at the flagship widths
   (``run_parallel``): the LINF-LP pixel step (B 16 of 48^2), the
   SRFlow-LP prior step and the SRFlow base frozen step (B 12 of 160^2)
   on one process (the reference), through the dp wrappers on NCCL at
   world 1 in this process, and on two gloo ranks sharing the card
   (``parallel.mesh.spawn``; NCCL refuses two ranks on one GPU), the
   LINF-LP step also sp 2; each step's loss and gradients held to the
   reference with the limits phase 10 holds the kernel path to the twin
   path (``hold_par``) and each rank's launches (PAR_LAUNCHES); the sp
   LINF-LP predict at 128^2 -> 512^2 (each rank's rows) and the dp
   SRFlow-LP predict of 2 LR images, one a rank, each within 1e-5 of the
   single predict; ms per step for each world size beside a line that
   says both ranks share one card.  Then the spatial SRFlow-LP predict
   (``SRFlowSpatialPredictor``: one LR's width over the ranks, a halo
   exchange at every op with a spatial extent): K3 (f32, bf16) and K5
   (f32, the served one-pass form) against their twins at a strip's
   shapes with its halo; at LR 128^2 -> 512^2 in ``high`` and ``default``
   and the ragged 101x85 in ``high``, kernel path and twin path, at NCCL
   world 1 (each strip bitwise the single predict's, no exchange) and on
   the two gloo ranks (each rank's kernel-path strip within 1e-5 of the
   single predict's columns of the same padded LR, its twin path's as
   ``check_srflow_predict`` holds a path, its kernel path against its
   twin path likewise, its launches the single predict's: K3 363, K5 48
   + 48); each rank's ms, exchanges and bytes.  It prints the phase's
   seconds and the run's;
18. (run after phase 2) the native host library (``bfsr_tpu_torch/
   native.py``, built with ``g++ -fopenmp`` from ``csrc/host/
   bfsr_native.cc``): the host CPU (``lscpu``) and cores, then at the
   pixel trainer's crop (LR 48^2 -> 192^2), the patch trainer's (144^2 ->
   576^2) and a DIV2K frame (510x339 -> 2040x1356) the up-down-up
   residual against ``wrappers.residuals_np`` (lr_up 3e-6, the residual
   5e-6), the bilinear resize with and without ``align_corners`` against
   ``resize_bilinear_np`` (2e-6) and the bicubic down against the float64
   ``imresize`` (1e-5; ``NATIVE_TOL``), each with its host ms beside the
   twin's; then the loader profile (``profiling/loader_times.py``): one
   crop sample of each trainer's real wrapper split into its host stages,
   and ``DataLoader`` batches/s with the residual from the native library
   and from its numpy twin.  Nothing of it enters the ``{"kernels":
   ...}`` line;
19. the learning curves (``bfsr_tpu_torch/profiling/train_curve.py``,
   ``srflow_train_curve.py``, ``prior_train_curve.py``) at full width on
   the kernels, each on the synthetic but learnable task of
   ``profiling/learnable_task.py`` (GT = the LR's bilinear-up plus a fixed
   checker): the LINF-LP prior (B 16 of 48^2 LR x2, latent L1) for 800
   steps, the SRFlow NLL (B 12 of 160^2 GT, the RRDB frozen on K3, Adam
   behind ``clip_by_global_norm(10)``) and the SRFlow-LP prior (fresh
   pairs each step, made on the card) for 200 each (``CURVE_STEPS``).
   Held (``hold_curve``): every loss and held-out metric finite, every
   step's launches those of a step of phases 10 (less the VGG term's K1
   inverse), 14 and 12 (``CURVE_LAUNCHES``), and
   ``tests/test_torch_convergence.py``'s margins (``CURVE_HOLDS``): the
   loss's fall and the trained weights' held-out PSNR (and NLL) against
   the initial weights and no prior.  It prints each curve's loss at the
   JAX scripts' marks, ms a step, its held-out metrics beside the card's
   name and power limit, and the phase's seconds.  Nothing of it enters
   the ``{"kernels": ...}`` line.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
route, source, the TPU kernel it replaces, its launches in its paths'
full-size predicts (512^2; 516^2 for the patch model) and the trainer's
step, its max abs error, its time beside the twin's and the one PyTorch
call's that computes the same function, where there is one, and its
bound: the least time the card could take for the same work, with the
peak it is taken at in ``bound_rate``: the f32-grade products of K2
and of the f32 K5 at C = 48 and 192 at 3xTF32, three TF32 products each
at the 495 TFLOP/s TF32 rate; K1, K2, K4, both K3s and K5 (f32 and the served one-pass form) also carry
``train_checks``, phases 10-12's checks at the trainers' shapes, K1's and
K4's inverse with ``FlowInverse``'s gradient, K5's reverse with
``FlowStepReverse``'s; K5 carries ``x8_checks``, phase 16's checks at
the 8x flow's four widths; both K3s and K5 (f32, served one-pass) carry
``strip_checks``, phase 17's checks at a spatial strip's shapes; ``launches_by_path`` gives a step's launches on
each trainer and mode, and an image's or a val batch's on the evaluation
entry points);
the last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": N}}``.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

# the checkout this script belongs to: bfsr_tpu_torch is imported from here
ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()  # the run's start

LR, HR = (128, 128), (512, 512)
RAGGED_LR, RAGGED_HR = (96, 80), (300, 250)
SRFLOW_RAGGED_LR = (101, 85)
# the patch model: bench.py's 172^2 centre grid (HR 516^2) and the
# wrapper's padded grid of a ragged x4 image
PATCH_GRID, PATCH_RAGGED_LR = (172, 172), (101, 85)
# K5 (atol, rtol): tests/test_flow_step_kernel.py's step tolerance; the
# SRFlow-LP image: docs/PARITY.md's; its unclipped output relative to its
# largest value, since a random flow's image lies mostly outside [0, 1]
TOL = {"linf_flow_forward": 1e-5, "linf_flow_inverse": 1e-4,
       "linf_info": (2e-4, 1e-4), "conv3x3_cat": 1e-4, "image": 1e-3,
       "flow_step_forward": (2e-4, 2e-4), "flow_step_reverse": (2e-4, 2e-4),
       "srflow_image": 5e-3, "srflow_unclipped_rel": 1e-3,
       "linf_flow_nd_forward": 2e-5, "linf_flow_nd_inverse": 2e-4,
       "patch_image": 5e-4, "patch_psnr_db": 0.01,
       # the bf16 K3 and its twin multiply the same bf16 values exactly and
       # differ only in the order of the f32 sums; K6 is K3's f32 kernel
       "conv3x3_cat_bf16": (1e-4, 1e-4), "conv3x3_fused": 1e-4,
       # a mode's image against the twin path in the same mode: under
       # default, f32 sums taken in another order flip the bf16 rounding of
       # values at a tie, and the flips spread through the 34 encoder convs
       # (PERF.md); each path is as close to high as the other
       "mode_image": {"mixed": 1e-3, "default": 5e-3},
       # K5's one-pass kernels against their twins: the same operands
       # rounded, f32 sums in another order, which can flip an
       # intermediate's bf16 rounding at a tie (PERF.md): max and mean
       # abs err
       "flow_step_bf16_forward": {"max": 2e-2, "mean": 1e-4},
       "flow_step_bf16_reverse": {"max": 2e-2, "mean": 1e-4},
       "flow_step_bf16_pallas_forward": {"max": 2e-2, "mean": 1e-4},
       "flow_step_bf16_pallas_reverse": {"max": 2e-2, "mean": 1e-4},
       # SRFlow-LP under default against its twin path, as PSNR in dB: the
       # served xla form rounds what the twin path's unfused steps round, so
       # the two differ only where sum order flips a bf16 rounding at a tie
       # (58.0-58.3 dB measured, PERF.md); 50 dB leaves 8 dB of margin and
       # still refuses the pallas form's 37.2
       "srflow_default_twin_db": 50.0,
       # FlowStepReverse's gradient against autograd through the twin: both
       # differentiate the same twin at the same saved state, so only the
       # order of the library's sums may differ; in the one-pass form that
       # can flip the bf16 rounding of a gradient at a tie, as in the
       # kernels above (3.1e-5 at level 3, PERF.md)
       "flow_step_reverse_grad": (1e-5, 1e-5),
       "flow_step_bf16_reverse_grad": {"max": 2e-2, "mean": 1e-4},
       # the evaluation entry points, kernel path against twin path: each
       # predict's image is held to TOL['image'] (TOL['srflow_image']) on
       # its own; the PSNRs at random weights lie near 6 dB, where 0.01
       # dB would let the MSE move 0.23%: 1e-4 dB (at most 2.8e-5 read,
       # PERF.md), and SSIM on uint8 images a rounding flip apart at most
       # here and there
       "eval_psnr_db": 1e-4, "eval_ssim": 1e-4}
# agreement (PSNR of a mode's output against high's, [0, 1] scale, as
# bench.py:run_precision_delta computes it, profiling/mode_agreement.py):
# sanity floors, in dB
# srflow default: the twin path's 47.5 dB against high (PERF.md) less 2.5
# dB of margin; the pallas form, which rounds the flow's state at 96 steps,
# reads 37.0 dB and keeps a 30 dB sanity floor
AGREEMENT_FLOOR_DB = {"mixed": 80.0, "default": 50.0, "srflow mixed": 80.0,
                      "srflow default": 45.0, "srflow default pallas": 30.0}
# H100 SXM published peaks at 700 W (NVIDIA's data sheet); K2's f32-grade
# products run as 3xTF32, three TF32 products each at the 495 TFLOP/s TF32
# rate
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_NAMES = {PEAK_F32_FLOPS: "f32 SIMT", PEAK_BF16_FLOPS: "bf16",
              PEAK_3XTF32_FLOPS: "3xTF32"}
HBM_BYTES_PER_S = 3.35e12
LINF_KERNELS = ("linf_flow_forward", "linf_flow_inverse", "linf_info",
                "conv3x3_cat")
# a patch predict's launches of each kernel (K3: 34 encoder convs, the
# prior's 5 dense, 2 inc and 2 last-up convs)
PATCH_LAUNCHES = {"linf_flow_nd_forward": 1, "linf_flow_nd_inverse": 1,
                  "linf_info": 1, "conv3x3_cat": 43, "linf_flow_forward": 0,
                  "linf_flow_inverse": 0}
# a LINF-LP predict's launches per mode: under mixed the prior's 9
# full-resolution convs take the bf16 K3, under default the encoder's 34 too
MODE_LAUNCHES = {
    mode: {"conv3x3_cat": 43 - bf16, "conv3x3_cat_bf16": bf16,
           "linf_flow_forward": 1, "linf_flow_inverse": 1, "linf_info": 1}
    for mode, bf16 in (("mixed", 9), ("default", 43))}
# the SRFlow-LP prior's K3 convs: 2 branches x (5 dense + 2 inc + 2 up)
SRFLOW_PRIOR_K3 = 18
# the trainer: batch, LR crop, scale range; a step's launches (the 34
# encoder convs on K3, the info once, the LR-up residual's encode and the
# decode on K1; the HR residual's encode too with the latent loss)
TRAIN_BATCH, TRAIN_INP, TRAIN_SCALE_MAX = 16, 48, 4
TRAIN_LAUNCHES = {"conv3x3_cat": 34, "linf_info": 1, "linf_flow_forward": 1,
                  "linf_flow_inverse": 1}
# the step on the kernel path against the twin path: the loss, relative
# (1e-7 to 1.4e-7 measured, PERF.md); FlowInverse's gradient (the same twin
# computes both) absolutely.  The prior's gradients are not continuous in
# the step's inputs: ReLU, LeakyReLU, max-pool and clip decisions and the
# L1 loss's signs at near-ties flip under any f32-level change, so the twin
# path itself, with gt_lr_up scaled by (1 + GRAD_NUDGE), moves them by up
# to ~4% of a tensor's largest value (~1% in L2; PERF.md).  Each
# tensor's relative L2 error against the twin path, and all of them as one
# vector, is held to GRAD_SPREAD_FACTOR x that nudge's worst relative L2
# change in the same run, never less than GRAD_FLOOR and never more than
# GRAD_CAP, half the distance of a gradient of zeros (1.0; a wrong one of
# the right size reads ~1.4, one of twice the size 1.0); a fault (a wrong
# sample, crop or layout) moves them by O(1).  Under default the patch
# trainer's bf16 VGG spreads single tensors by up to 0.21 (PERF.md).
TRAIN_TOL = {"loss_rel": 1e-5, "flow_inverse_grad": 1e-5}
GRAD_NUDGE, GRAD_SPREAD_FACTOR, GRAD_FLOOR, GRAD_CAP = 1e-7, 2.0, 1e-3, 0.5
# the patch trainer's step (ps = 3, d = 27): the 34 encoder convs on K3 over
# the 144^2 LR crops, the info once at out 540, K4's forward of the LR-up
# residual (twice with the latent loss) and its inverse; no K1
PATCH_TRAIN_LAUNCHES = {"conv3x3_cat": 34, "linf_info": 1,
                        "linf_flow_nd_forward": 1, "linf_flow_nd_inverse": 1}
# a trainer's step under a bf16 mode.  Two runs of the step that differ at
# the f32 level (the kernel path and the twin path) flip bf16 roundings at
# ties, and the flips reach the L1 loss's signs through the random VGG:
# whole-step gradients differ by 0.13-0.64 in relative L2, and even from
# the same frozen values, where only the flow inverse's forward differs
# (by ~1e-7), how many roundings flip is a matter of chance, so one
# nudge's spread is no measure of it (PERF.md).  The kernels are held
# launch by launch instead: the frozen part on the kernel path's own
# values (each of the encoder's 34 K3 launches, K2, the flow forward)
# within each kernel's own tolerance (TOL); the flow inverse reads no mode
# and is held with its gradient at the step's shapes by
# check_train_kernels.  The trainable part then runs on both paths from
# those values as a sanity check: each gradient and all as one vector
# within GRAD_CAP, the loss within loss_rel = 2^-10, half the relative
# rounding of one bf16 operand.  Against high's loss on the same batch:
# every operand of a bf16 conv carries a relative error of at most 2^-9;
# vs_high_rel is five times that, a sanity floor as the serving modes'
# agreement floors are.
MODE_TRAIN_TOL = {"vs_high_rel": 1e-2, "loss_rel": 2.0 ** -10}
# phase 13: the eval data (HR 256x192, x4), the DIV2K-size frame, the val
# batches, and each entry point's launches an image or a val batch, under
# high: the test.py twin's (the grid predict), its patch model's, a val
# batch's (the encoder's 34 and the prior's 9 convs at B 16, K1 both ways
# over 36,864 queries; the info at each query's own coords is plain torch,
# no K2) and the srflow_test.py twin's
EVAL_HR, EVAL_SCALE, EVAL_DIV2K_HR = (192, 256), 4, (1356, 2040)
# phase 18: the native host library (bfsr_tpu_torch/native.py) at the
# pixel trainer's crop, the patch trainer's and a DIV2K frame (LR -> HR),
# held to its twins within tests/test_native.py's limits: the bilinear
# resize and lr_up against resize_bilinear_np, the residual against
# wrappers.residuals_np, the bicubic against the float64 imresize
NATIVE_SHAPES = [("pixel crop", (48, 48), (192, 192)),
                 ("patch crop", (144, 144), (576, 576)),
                 ("div2k frame", (339, 510), (1356, 2040))]
NATIVE_TOL = {"bilinear": 2e-6, "lr_up": 3e-6, "residual": 5e-6,
              "bicubic": 1e-5}
VAL_BATCH, VAL_BATCHES, VAL_INP = 16, 2, 48
EVAL_LAUNCHES = {
    "test": {"conv3x3_cat": 43, "linf_info": 1, "linf_flow_forward": 1,
             "linf_flow_inverse": 1},
    "test_patch": {"conv3x3_cat": 43, "linf_info": 1,
                   "linf_flow_nd_forward": 1, "linf_flow_nd_inverse": 1},
    "val": {"conv3x3_cat": 43, "linf_flow_forward": 1,
            "linf_flow_inverse": 1},
    "srflow_test": {"conv3x3_cat": 363, "flow_step_forward": 48,
                    "flow_step_reverse": 48}}
KERNELS = {
    "linf_flow_forward": ("bfsr_tpu_torch/csrc/linf_flow.cu",
                          "bfsr_tpu/ops/pallas/linf_flow.py:47"),
    "linf_flow_inverse": ("bfsr_tpu_torch/csrc/linf_flow.cu",
                          "bfsr_tpu/ops/pallas/linf_flow.py:26"),
    "linf_flow_nd_forward": ("bfsr_tpu_torch/csrc/linf_flow_nd.cuh",
                             "bfsr_tpu/ops/pallas/linf_flow.py:82"),
    "linf_flow_nd_inverse": ("bfsr_tpu_torch/csrc/linf_flow_nd.cuh",
                             "bfsr_tpu/ops/pallas/linf_flow.py:66"),
    "linf_info": ("bfsr_tpu_torch/csrc/linf_info.cu",
                  "bfsr_tpu/ops/pallas/linf_info.py:73"),
    "conv3x3_cat": ("bfsr_tpu_torch/csrc/conv3x3.cu",
                    "bfsr_tpu/ops/pallas/s2d_conv.py:128"),
    "flow_step_forward": ("bfsr_tpu_torch/csrc/flow_step.cu",
                          "bfsr_tpu/ops/pallas/flow_step.py:261"),
    "flow_step_reverse": ("bfsr_tpu_torch/csrc/flow_step.cu",
                          "bfsr_tpu/ops/pallas/flow_step.py:303"),
    "flow_step_bf16_forward": ("bfsr_tpu_torch/csrc/flow_step_bf16.cu",
                               "bfsr_tpu/ops/pallas/flow_step.py:261"),
    "flow_step_bf16_reverse": ("bfsr_tpu_torch/csrc/flow_step_bf16.cu",
                               "bfsr_tpu/ops/pallas/flow_step.py:303"),
    "flow_step_bf16_pallas_forward": ("bfsr_tpu_torch/csrc/flow_step_bf16.cu",
                                      "bfsr_tpu/ops/pallas/flow_step.py:261"),
    "flow_step_bf16_pallas_reverse": ("bfsr_tpu_torch/csrc/flow_step_bf16.cu",
                                      "bfsr_tpu/ops/pallas/flow_step.py:303"),
    "conv3x3_cat_bf16": ("bfsr_tpu_torch/csrc/conv3x3_bf16.cu",
                         "bfsr_tpu/ops/pallas/s2d_conv.py:128"),
    "conv3x3_fused": ("bfsr_tpu_torch/csrc/conv3x3.cu",
                      "bfsr_tpu/ops/pallas/conv3x3.py:28"),
    "conv_probe": ("bfsr_tpu_torch/csrc/conv3x3_bf16.cu",
                   "profiling/mosaic_probe.py:36"),
}


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def precision(mode):
    """Run the block under precision mode ``mode``, then restore."""
    from bfsr_tpu_torch.ops import nn as fnn

    saved = fnn.precision_mode()
    fnn.set_default_precision(mode)
    try:
        yield
    finally:
        fnn.set_default_precision(saved)


def in_mode(mode, fn):
    """fn, run under precision mode ``mode``."""
    def run():
        with precision(mode):
            return fn()
    return run


def gpu_time_ms(fn, iters=10):
    """Mean device time of fn() over ``iters`` launches (CUDA events).  A
    sleep on the stream first holds the device while the host enqueues
    all ``iters`` calls (1.5x the host time they took, at 2 GHz or
    longer), so a call whose host work outlasts its kernels is still
    timed on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * (1.5 * host_ms + 1.0)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes, peak=PEAK_F32_FLOPS):
    """The least time for the work: the larger of its operations over the
    peak rate of their type (f32 unless named) and its bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak, n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": PEAK_NAMES[peak]}


def within(got, ref, tol):
    """(whether ``got`` is finite and within ``tol`` of ``ref``, the max
    abs error, the tolerance as text).  tol: an atol; (atol, rtol),
    elementwise; or {"max", "mean"} abs errors."""
    import torch

    err = (got - ref).abs()
    max_abs = float(err.max())
    if isinstance(tol, dict):
        # max and mean abs err; the share past 1e-4 + 1e-4 rel is reported
        mean = float(err.mean())
        share = float((err > 1e-4 + 1e-4 * ref.abs()).float().mean())
        ok = max_abs <= tol["max"] and mean <= tol["mean"]
        tol_s = (f"atol {tol['max']:g}; mean {mean:.3e} (at most "
                 f"{tol['mean']:g}), {share:.2e} of elements past 1e-4 + "
                 "1e-4 rel")
    elif isinstance(tol, tuple):
        atol, rtol = tol
        ok = bool((err <= atol + rtol * ref.abs()).all())
        tol_s = f"atol {atol:g} + rtol {rtol:g}"
    else:
        ok = max_abs <= tol
        tol_s = f"atol {tol:g}"
    return bool(torch.isfinite(got).all()) and ok, max_abs, tol_s


def compare(name, kernel_fn, plain_fn, tol, flops=None, label="",
            n_bytes=None, library_fn=None, peak=PEAK_F32_FLOPS, launches=1,
            cost=None):
    """Run both once, check agreement (and that ``kernel_fn`` launched
    kernel ``name`` ``launches`` times), time both (and ``library_fn``,
    one PyTorch call computing the same function, where there is one);
    with ``n_bytes`` also the bound at ``peak`` (and, at the 3xTF32 peak,
    the SIMT f32 bound beside it), or with ``cost`` (K5's
    ``ops/cuda/flow_step.py:k5_cost``) its flops, bytes and bound.
    Returns a result dict."""
    import torch

    from bfsr_tpu_torch.ops import cuda

    if cost is not None:
        flops, n_bytes = cost["flops"], cost["bytes"]
    before = dict(cuda.LAUNCHES)
    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if cuda.LAUNCHES[name] != before[name] + launches:
        raise RuntimeError(f"{name}: the wrapper did not launch its kernel "
                           f"{launches} time(s)")
    ok, max_abs, tol_s = within(got, ref, tol)
    if not ok:
        raise RuntimeError(f"{name}{label}: kernel disagrees with its twin: "
                           f"max abs err {max_abs:.3e} ({tol_s}), max |ref| "
                           f"{float(ref.abs().max()):.3e}")
    ms, plain_ms = gpu_time_ms(kernel_fn), gpu_time_ms(plain_fn)
    library_ms = gpu_time_ms(library_fn) if library_fn else None
    rate = ""
    if flops:
        rate = (f"  {flops / ms / 1e6:.1f} GFLOP/s vs twin "
                f"{flops / plain_ms / 1e6:.1f}")
    out = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms}
    extra = ""
    if library_ms is not None:
        extra += f", library {library_ms:.4f} ms"
    if n_bytes is not None:
        out.update({k: cost[k] for k in ("bound_ms", "bound_by", "bound_rate")}
                   if cost is not None else bound(flops or 0, n_bytes, peak))
        extra += (f", bound {out['bound_ms']:.4f} ms ({out['bound_by']} at "
                  f"{out['bound_rate']}: {(flops or 0) / 1e9:.3f} GFLOP, "
                  f"{n_bytes / 1e6:.2f} MB; the kernel at "
                  f"{out['bound_ms'] / ms:.1%} of it)")
        if peak == PEAK_3XTF32_FLOPS and cost is None:
            simt = bound(flops or 0, n_bytes)["bound_ms"]
            extra += f"; SIMT f32 bound {simt:.4f} ms ({simt / ms:.1%})"
    log(f"check {name}{label}: max_abs_err {max_abs:.3e} ({tol_s}), max |ref| "
        f"{float(ref.abs().max()):.3e}; kernel {ms:.4f} ms, twin "
        f"{plain_ms:.4f} ms{extra}{rate}")
    return out


def check_kernels(model, prior, inputs, ragged_inputs):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    import torch

    from bfsr_tpu_torch.ops import nn as fnn
    from bfsr_tpu_torch.ops.cuda import conv3x3, linf_flow, linf_info

    results = {}
    for tag, (inp, coord, cell, gt) in (("flagship", inputs),
                                        ("ragged", ragged_inputs)):
        with torch.inference_mode():
            feat = model.gen_feat(inp, kernels=False)
            coef, freq = model.head(feat)
            phase = model.phase_of(cell, inp.shape[1], inp.shape[2])
            cy = coord[0, :, 0, 0].contiguous()
            cx = coord[0, 0, :, 1].contiguous()
            args = (coef, freq, cy, cx, phase, model.mlp())
            C, n = coef.shape[-1], cy.shape[0] * cx.shape[0]
            flops = 2 * n * sum(w.shape[0] * w.shape[1] for w, _ in model.mlp())
            out_dim = model.mlp()[-1][0].shape[0]
            r = compare("linf_info",
                        lambda: linf_info.affine_info(*args, model.mlp_packed),
                        lambda: linf_info.affine_info_plain(*args),
                        TOL["linf_info"], flops, f" {tag} C={C}",
                        nbytes(coef, freq, cy, cx, phase, model.mlp_packed)
                        + 4 * out_dim * n, peak=PEAK_3XTF32_FLOPS)
            results.setdefault("linf_info", []).append(r)
            if tag == "ragged":
                continue
            info = linf_info.affine_info_plain(*args)
            flow = model.imnet
            x = gt.reshape(-1, 3).contiguous()
            z = linf_flow.flow_forward_plain(flow.w, flow.b, x, info)
            # per query and layer: a 3x3 matvec + bias (21 flop) and the
            # affine coupling of 3 channels (sigmoid, scale, shift: 15)
            n_layers = flow.w.shape[0] - 1
            k1_flops = n * (36 * n_layers + 21)
            k1_bytes = nbytes(flow.w, flow.b, x, info) + x.numel() * 4
            results["linf_flow_forward"] = [compare(
                "linf_flow_forward",
                lambda: linf_flow.flow_forward(flow.w, flow.b, x, info),
                lambda: linf_flow.flow_forward_plain(flow.w, flow.b, x, info),
                TOL["linf_flow_forward"], k1_flops, f" N={n}", k1_bytes)]
            results["linf_flow_inverse"] = [compare(
                "linf_flow_inverse",
                lambda: linf_flow.flow_inverse(flow.w_inv, flow.b, z, info),
                lambda: linf_flow.flow_inverse_plain(flow.w_inv, flow.b, z,
                                                     info),
                TOL["linf_flow_inverse"], k1_flops, f" N={n}", k1_bytes)]

    for case in linf_k3_cases(model, prior):
        results.setdefault("conv3x3_cat", []).append(check_k3(*case))
    return results


def linf_k3_cases(model, prior):
    """(label, inputs, conv, scale, bias, act) of the LINF-LP convs the K3
    checks hold: the encoder's, ``dense5c`` conv5 and the last ``up``
    conv1, on random inputs from a seeded generator."""
    import torch

    from bfsr_tpu_torch.ops import nn as fnn

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    H, W = HR
    enc = model.encoder.body[0].body[0]
    dense5 = prior.input_proj.conv5
    up_dc = prior.up_layers[-1].conv.double_conv
    s_up, b_up = fnn.fold_bn(up_dc[1])
    # each conv with the weight layouts its frozen module keeps
    return [
        ("encoder 64->64 @128^2", [randn(1, *LR, 64)], enc, None,
         enc.bias, "relu"),
        ("dense5c conv5 5 inputs 131->32 @512^2",
         [randn(1, H, W, 3)] + [randn(1, H, W, 32) for _ in range(4)],
         dense5, None, dense5.bias, None),
        ("up conv1 64+64->64 @512^2 (BN folded)",
         [randn(1, H, W, 64), randn(1, H, W, 64)], up_dc[0], s_up, b_up,
         "lrelu"),
    ]


def check_k3(label, xs, conv, s, b, act):
    """K3 against its twin on one conv of the path, with its frozen weight
    layout (kweight); the library call is cuDNN f32 (TF32 off) on the
    concatenated NCHW input with the scale folded into the weight: the
    same conv and epilogue, without the activation."""
    import torch
    import torch.nn.functional as F

    from bfsr_tpu_torch.ops.cuda import conv3x3

    w = conv.weight
    B, H, W = xs[0].shape[:3]
    with torch.inference_mode():
        flops = 2 * 9 * w.shape[1] * w.shape[0] * H * W * B
        xcat = torch.cat(xs, -1).permute(0, 3, 1, 2).contiguous()
        wl = w if s is None else w * s[:, None, None, None]
        n_bytes = nbytes(*xs, conv.kweight, *[t for t in (s, b) if t is not None])
        return compare(
            "conv3x3_cat",
            lambda: conv3x3.conv3x3_cat(xs, w, s, b, act, kweight=conv.kweight),
            lambda: conv3x3.conv3x3_cat_plain(xs, w, s, b, act),
            TOL["conv3x3_cat"], flops, f" {label}",
            n_bytes + 4 * w.shape[0] * H * W * B,
            lambda: F.conv2d(xcat, wl, b, padding=1))


def check_k3_bf16(label, xs, conv, s, b, act):
    """The bf16 K3 against its twin on one conv of the path, with its
    frozen bf16 layout (kweight_bf16); the library call is cuDNN bf16 on
    the concatenated NCHW input in bf16 with the scale folded into the
    weight (bf16 out), without the activation; the bound is at the bf16
    peak."""
    import torch
    import torch.nn.functional as F

    from bfsr_tpu_torch.ops.cuda import conv3x3

    w = conv.weight
    B, H, W = xs[0].shape[:3]
    with torch.inference_mode():
        flops = 2 * 9 * w.shape[1] * w.shape[0] * H * W * B
        xcat = torch.cat(xs, -1).permute(0, 3, 1, 2).contiguous().bfloat16()
        wl = (w if s is None else w * s[:, None, None, None]).bfloat16()
        bl = None if b is None else b.bfloat16()
        n_bytes = nbytes(*xs, conv.kweight_bf16,
                         *[t for t in (s, b) if t is not None])
        return compare(
            "conv3x3_cat_bf16",
            lambda: conv3x3.conv3x3_cat_bf16(xs, w, s, b, act,
                                             kweight_bf16=conv.kweight_bf16),
            lambda: conv3x3.conv3x3_cat_bf16_plain(xs, w, s, b, act),
            TOL["conv3x3_cat_bf16"], flops, f" {label}",
            n_bytes + 4 * w.shape[0] * H * W * B,
            lambda: F.conv2d(xcat, wl, bl, padding=1), peak=PEAK_BF16_FLOPS)


def k6_cases(prior):
    """(label, x, weight, scale, bias, act, launches) of the K6 checks: the
    last up conv2 (64 -> 64 @512^2, BN folded, LeakyReLU) and a random
    Cout-100 conv at 300x250 (launches of 64 and of 36 padded to 64)."""
    import torch

    from bfsr_tpu_torch.ops import nn as fnn

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dc = prior.up_layers[-1].conv.double_conv
    s, b = fnn.fold_bn(dc[4])
    return [("64->64 @512^2 (BN folded, lrelu)", randn(1, *HR, 64),
             dc[3].weight, s, b, "lrelu", 1),
            ("64->100 @300x250 (ragged Cout)", randn(1, *RAGGED_HR, 64),
             randn(100, 64, 3, 3) / 24.0, None, randn(100), None, 2)]


def check_k6(cases):
    """K6 against its twin (``conv3x3_cat_plain`` of its one input); the
    library call is cuDNN f32 with the scale folded in."""
    import torch
    import torch.nn.functional as F

    from bfsr_tpu_torch.ops.cuda import conv3x3

    results = []
    with torch.inference_mode():
        for label, x, w, s, b, act, n in cases:
            H, W = x.shape[1], x.shape[2]
            xn = x.permute(0, 3, 1, 2).contiguous()
            wl = w if s is None else w * s[:, None, None, None]
            results.append(compare(
                "conv3x3_fused",
                lambda: conv3x3.conv3x3_fused(x, w, s, b, act),
                lambda: conv3x3.conv3x3_cat_plain([x], w, s, b, act),
                TOL["conv3x3_fused"], 2 * 9 * w.shape[1] * w.shape[0] * H * W,
                f" {label}",
                nbytes(x, w, *[t for t in (s, b) if t is not None])
                + 4 * w.shape[0] * H * W,
                lambda: F.conv2d(xn, wl, b, padding=1), launches=n))
    return results


def run_k6_entry(cases):
    """K6's own entry (no inference path calls it) once at each case, with
    the launch counters reset."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.ops.cuda import conv3x3

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with torch.inference_mode():
        for _, x, w, s, b, act, _ in cases:
            conv3x3.conv3x3_fused(x, w, s, b, act)
    torch.cuda.synchronize()
    log(f"k6 entry: launches {json.dumps(cuda.LAUNCHES)}")
    return dict(cuda.LAUNCHES)


def run_probe():
    """P1-P3 through ``conv_probe.run()`` with the launch counters reset:
    its line, its result for the kernels line and its launches."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.profiling import conv_probe as cp

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    r = cp.run()
    torch.cuda.synchronize()
    n = cuda.LAUNCHES["conv3x3_cat_bf16"]
    px = cp.SIZE * cp.SIZE
    n_bytes = 4 * px * cp.CIN + 2 * 9 * cp.CIN * cp.COUT + 4 * px * cp.COUT
    out = {"max_abs_err": r["twin_max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
           **bound(r["flops"], n_bytes, PEAK_BF16_FLOPS)}
    log(f"probe conv_probe (P1-P3: 3x3 conv {cp.CIN}->{cp.COUT} "
        f"@{cp.SIZE}^2, bf16 operands, f32 accumulate): {r['ms']:.4f} ms, "
        f"{r['tflops']:.1f} TFLOP/s useful; max abs err vs the f32 conv "
        f"{r['max_abs_err']:.3e} (max |ref| {r['max_abs_ref']:.3f}), vs the "
        f"bf16 twin {r['twin_max_abs_err']:.3e} (atol {cp.TOL[0]:g} + rtol "
        f"{cp.TOL[1]:g}); twin {r['plain_ms']:.4f} ms, cuDNN bf16 "
        f"{r['library_ms']:.4f} ms ({r['flops'] / r['library_ms'] / 1e9:.1f} "
        f"TFLOP/s); bound {out['bound_ms']:.4f} ms ({out['bound_by']}); "
        f"{n} launches")
    return out, {"conv_probe": n}


def check_predict_mode(model, prior, inputs, label, mode):
    """LINF-LP under a bf16 mode: the launches, the image against the twin
    path in the same mode, and its agreement with ``high``'s output."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    high = LINFPredictor(model, prior).predict(*inputs)
    with precision(mode):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        out = LINFPredictor(model, prior).predict(*inputs)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        ref = LINFPredictor(model, prior, kernels=False).predict(*inputs)
    torch.cuda.synchronize()
    if out.shape != high.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"predict {label} {mode}: bad output "
                           f"{tuple(out.shape)}")
    want = MODE_LAUNCHES[mode]
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong:
        raise RuntimeError(f"predict {label} {mode}: launches {launches}, "
                           f"expected {want}")
    err = float((out - ref).abs().max())
    db, floor = agreement_db(out, high), AGREEMENT_FLOOR_DB[mode]
    log(f"predict {label} {mode}: shape {tuple(out.shape)}, finite, launches "
        f"{json.dumps(launches)}, max |kernel - twin| {err:.3e} (tol "
        f"{TOL['mode_image'][mode]:g})")
    log(f"agreement {label} {mode} vs high: {db:.3f} dB (floor {floor:g}), "
        f"max |{mode} - high| {float((out - high).abs().max()):.3e}")
    if not (err <= TOL["mode_image"][mode] and db >= floor):
        raise RuntimeError(f"predict {label} {mode}: twin error {err:.3e}, "
                           f"agreement {db:.3f} dB")
    return launches


def check_predict(model, prior, inputs, label):
    """Phase 4: the LINF-LP path through the kernels vs through the twins."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    inp, coord, cell, gt = inputs
    kernel_path = LINFPredictor(model, prior, kernels=True)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    out = kernel_path.predict(inp, coord, cell, gt)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    ref = LINFPredictor(model, prior, kernels=False).predict(inp, coord, cell, gt)
    torch.cuda.synchronize()
    if out.shape != (1, *coord.shape[1:3], 3) or not torch.isfinite(out).all():
        raise RuntimeError(f"predict {label}: bad output {tuple(out.shape)}")
    missing = [k for k in LINF_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"predict {label}: kernels not launched: {missing}")
    err = float((out - ref).abs().max())
    log(f"predict {label}: shape {tuple(out.shape)}, finite, launches "
        f"{json.dumps(launches)}, max |kernel - twin| {err:.3e} (tol "
        f"{TOL['image']:g}), max |out| {float(out.abs().max()):.3f}")
    if not err <= TOL["image"]:
        raise RuntimeError(f"predict {label}: kernel path disagrees with the "
                           f"twin path: {err:.3e}")
    return launches


def time_paths(paths, mp, label, blocks=3, per_block=5):
    """ms/image of each path (name -> fn), 2 warm-ups each, then blocks
    interleaved: the paths in order, then reversed, and so on (twin,
    kernel, kernel, twin, twin, kernel for two)."""
    import torch

    for fn in paths.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in paths}
    names = list(paths)
    order = [k for b in range(blocks)
             for k in (names if b % 2 == 0 else names[::-1])]
    for k in order:
        t0 = time.perf_counter()
        for _ in range(per_block):
            paths[k]()
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) * 1e3 / per_block)
    out = {}
    for k, ts in times.items():
        med, best = statistics.median(ts), min(ts)
        out[k] = med
        log(f"time {label} {k} path: median {med:.3f} ms/image, best "
            f"{best:.3f} ms/image, {mp / med * 1e3:.3f} HR MP/s (median); "
            f"blocks {[round(t, 3) for t in ts]}")
    return out


def profile_predict(fn, unprofiled_ms, label, top=14, what="predict"):
    """One kernel-path predict (or ``what``) ``fn()`` under torch.profiler:
    device time by kernel (device-side events only, so a CPU op and its
    kernels are not counted twice), the busy share of the profiled wall
    time, and an estimate of the idle share of an unprofiled one
    (``unprofiled_ms``, the median of this run's timing blocks)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f"profile {label}: the profiler recorded no device time (not "
            f"measured)")
        return
    busy = sum(r[0] for r in rows) / 1e3
    log(f"profile {label}: one kernel-path {what}: {busy:.3f} ms of kernels "
        f"in {wall_ms:.3f} ms wall under the profiler (busy share "
        f"{100 * busy / wall_ms:.1f}%), {sum(r[2] for r in rows)} launches; "
        f"idle share of an unprofiled {what}, estimated against this run's "
        f"median {unprofiled_ms:.3f} ms: "
        f"{100 * max(0.0, 1 - busy / unprofiled_ms):.1f}%")
    for dev_us, key, count in sorted(rows, reverse=True)[:top]:
        log(f"profile {label}: {dev_us / 1e3:8.3f} ms "
            f"{100 * dev_us / 1e3 / busy:5.1f}% x{count} {key[:100]}")
    # K5's launches in either precision and K4's in both directions,
    # however many rows they take
    for kid, key in (("K5", "flow_step"), ("K4", "flow_nd_kernel")):
        sel = [r for r in rows if key in r[1]]
        if sel:
            ms = sum(r[0] for r in sel) / 1e3
            log(f"profile {label}: {kid} ({key}*) {ms:.3f} ms "
                f"{100 * ms / busy:5.1f}% x{sum(r[2] for r in sel)}")


# ---------------------------------------------------------------------------
# SRFlow-LP
# ---------------------------------------------------------------------------


def first_steps(model, lr):
    """(plan entry, step, record) of the first conditional step of each
    level, its record for this LR image or batch (computed in the current
    mode; under no_grad, not inference_mode, so that FlowStepReverse can
    save it for backward)."""
    import torch

    with torch.no_grad():
        cache = model.precompute_ft(model.rrdb_preprocess(lr, kernels=False))
    out, seen = [], set()
    for e, step, rec in zip(model.plan, model.flowUpsamplerNet.layers, cache):
        if e["kind"] == "step_cond" and e["level"] not in seen:
            seen.add(e["level"])
            out.append((e, step, rec))
    return out


def check_srflow_kernels(model, lr):
    """K5 forward and reverse against the twin at each level's shape, on
    the step's real weights and conditioning record (the first
    conditional step of each level, for this LR image), and K3 at an RRDB
    dense-block conv."""
    import torch

    from bfsr_tpu_torch.ops.cuda import flow_step as k5

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for e, step, rec in first_steps(model, lr):
        c, hid = e["c"], step.hidden
        hw = rec.shape[1:3]
        x = torch.randn((1, *hw, c), generator=gen, device="cuda")
        cost = k5.k5_cost(c, hid, hw, step.kpacked)
        label = f" level {e['level']} ({hw[0]}, {hw[1]}, {c})"
        with torch.inference_mode():
            y = k5.flow_step_forward_plain(x, rec, step.kpacked, hid)
            for name, fn, plain, inp in (
                    ("flow_step_forward", k5.flow_step_forward,
                     k5.flow_step_forward_plain, x),
                    ("flow_step_reverse", k5.flow_step_reverse,
                     k5.flow_step_reverse_plain, y)):
                results.setdefault(name, []).append(compare(
                    name, lambda: fn(inp, rec, step.kpacked, hid),
                    lambda: plain(inp, rec, step.kpacked, hid), TOL[name],
                    label=label, cost=cost))
    results["conv3x3_cat"] = [check_k3(*case)
                              for case in rrdb_k3_cases(model, lr)]
    return results


def rrdb_k3_cases(model, lr):
    """(label, inputs, conv, scale, bias, act) of two RRDB dense-block
    convs at the LR extent and batch: conv4 (4 inputs, Cout 32, LeakyReLU;
    conv1-4 are 276 of a predict's 363 K3 launches) and conv5 (5 inputs,
    Cout 64), on random inputs from a seeded generator."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    # SRFlow's RRDB, or an RRDBNet itself (LINF's RRDB encoder)
    rdb = getattr(model, "RRDB", model).RRDB_trunk[0].RDB1
    nf, gc = rdb.conv1.weight.shape[1], rdb.conv1.weight.shape[0]
    xs = [torch.randn((lr.shape[0], *lr.shape[1:3], ch), generator=gen,
                      device="cuda") for ch in [nf] + [gc] * 4]
    at = (f"@{lr.shape[1]}^2" if lr.shape[0] == 1
          else f"B={lr.shape[0]} @{lr.shape[1]}^2")
    return [(f"RRDB dense conv4 4 inputs {nf + 3 * gc}->{gc} {at}",
             xs[:4], rdb.conv4, None, rdb.conv4.bias, "lrelu"),
            (f"RRDB dense conv5 5 inputs {nf + 4 * gc}->{nf} {at}",
             xs, rdb.conv5, None, rdb.conv5.bias, None)]


def check_srflow_predict(model, prior, lr_img, label):
    """The SRFlow-LP path through the kernels vs through the twins."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                      pad_to_multiple)

    n_cond = sum(e["kind"] == "step_cond" for e in model.plan)
    kernel_path = SRFlowLPPredictor(model, prior, kernels=True)
    twin_path = SRFlowLPPredictor(model, prior, kernels=False)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    out = kernel_path.predict(lr_img)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    ref = twin_path.predict(lr_img)
    h, w = lr_img.shape[:2]
    if out.shape != (4 * h, 4 * w, 3) or not torch.isfinite(out).all():
        raise RuntimeError(f"srflow predict {label}: bad output "
                           f"{tuple(out.shape)}")
    want = {"flow_step_forward": n_cond, "flow_step_reverse": n_cond}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong or launches["conv3x3_cat"] == 0:
        raise RuntimeError(f"srflow predict {label}: launches {launches}, "
                           f"expected K5 {n_cond} each way and K3 > 0")
    err = float((out - ref).abs().max())
    x = pad_to_multiple(lr_img)
    sr, sr_ref = kernel_path.run(x), twin_path.run(x)
    torch.cuda.synchronize()
    scale = float(sr_ref.abs().max())
    rel = float((sr - sr_ref).abs().max()) / scale
    inside = float(((sr_ref > 0) & (sr_ref < 1)).float().mean())
    log(f"srflow predict {label}: shape {tuple(out.shape)}, finite, launches "
        f"{json.dumps(launches)}, max |kernel - twin| {err:.3e} (tol "
        f"{TOL['srflow_image']:g}); unclipped: max |kernel - twin| / max |twin|"
        f" {rel:.3e} (tol {TOL['srflow_unclipped_rel']:g}), max |twin| "
        f"{scale:.3f}, {100 * inside:.1f}% of it inside (0, 1)")
    if not (err <= TOL["srflow_image"] and rel <= TOL["srflow_unclipped_rel"]
            and torch.isfinite(sr).all()):
        raise RuntimeError(f"srflow predict {label}: kernel path disagrees "
                           f"with the twin path: {err:.3e} / {rel:.3e}")
    return launches


def check_srflow_mixed(model, prior, lr_img, label, launches_high):
    """SRFlow-LP under ``mixed``: the bf16 K3 only in the prior, K5 in
    f32; the image against the twin path in the same mode and its
    agreement with ``high``'s."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                      pad_to_multiple)
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    n_cond = sum(e["kind"] == "step_cond" for e in model.plan)
    kernel_path = SRFlowLPPredictor(model, prior, kernels=True)
    twin_path = SRFlowLPPredictor(model, prior, kernels=False)
    high = kernel_path.predict(lr_img)
    with precision("mixed"):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        out = kernel_path.predict(lr_img)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        ref = twin_path.predict(lr_img)
        x = pad_to_multiple(lr_img)
        sr, sr_ref = kernel_path.run(x), twin_path.run(x)
    torch.cuda.synchronize()
    want = {"flow_step_forward": n_cond, "flow_step_reverse": n_cond,
            "conv3x3_cat_bf16": SRFLOW_PRIOR_K3,
            "conv3x3_cat": launches_high["conv3x3_cat"] - SRFLOW_PRIOR_K3}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong or out.shape != high.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"srflow predict {label} mixed: launches "
                           f"{launches}, expected {want}")
    err = float((out - ref).abs().max())
    rel = float((sr - sr_ref).abs().max()) / float(sr_ref.abs().max())
    db, floor = agreement_db(out, high), AGREEMENT_FLOOR_DB["srflow mixed"]
    log(f"srflow predict {label} mixed: shape {tuple(out.shape)}, finite, "
        f"launches {json.dumps(launches)}, max |kernel - twin| {err:.3e} "
        f"(tol {TOL['srflow_image']:g}); unclipped: max |kernel - twin| / "
        f"max |twin| {rel:.3e} (reported)")
    log(f"agreement srflow {label} mixed vs high: {db:.3f} dB (floor "
        f"{floor:g}), max |mixed - high| {float((out - high).abs().max()):.3e}")
    if not (err <= TOL["srflow_image"] and db >= floor
            and torch.isfinite(sr).all()):
        raise RuntimeError(f"srflow predict {label} mixed: twin error "
                           f"{err:.3e}, agreement {db:.3f} dB")
    return launches


def check_srflow_kernels_bf16(model, lr):
    """Both of K5's one-pass forms, forward and reverse, against their
    twins at each level's shape under ``default``: the first conditional
    step of each level on its ``default`` record for this LR image, the
    served ``xla`` form on the step's ``kpacked_bf16``, the ``pallas`` form
    on a buffer packed here; the bound by ``k5_cost``.  Then the bf16 K3
    at the RRDB's conv4 and conv5."""
    import torch

    from bfsr_tpu_torch.ops.cuda import flow_step as k5

    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    with precision("default"):
        for e, step, rec in first_steps(model, lr):
            c, hid = e["c"], step.hidden
            hw = rec.shape[1:3]
            x = torch.randn((1, *hw, c), generator=gen, device="cuda")
            label = f" level {e['level']} ({hw[0]}, {hw[1]}, {c})"
            for form in k5.STEP_FORMS:
                pb = (step.kpacked_bf16 if form == step.step_form else
                      k5.pack_step_bf16(step.actnorm, step.invconv,
                                        step.affine, form))
                cost = k5.k5_cost(c, hid, hw, pb, form)
                with torch.inference_mode():
                    fwd = k5.BF16_FORMS[form, False]
                    rev = k5.BF16_FORMS[form, True]
                    y = fwd[1](x, rec, pb, hid)
                    for (name, plain), fn, inp in (
                            (fwd, k5.flow_step_forward, x),
                            (rev, k5.flow_step_reverse, y)):
                        results.setdefault(name, []).append(compare(
                            name, lambda: fn(inp, rec, step.kpacked, hid, pb,
                                             form),
                            lambda: plain(inp, rec, pb, hid), TOL[name],
                            label=f" {form}{label}", cost=cost))
    results["conv3x3_cat_bf16"] = [check_k3_bf16(*case)
                                   for case in rrdb_k3_cases(model, lr)]
    return results


def check_srflow_default(model, prior, lr_img, label, launches_high):
    """SRFlow-LP under ``default``: every stage bf16, the RRDB's and the
    prior's K3 convs on the bf16 K3 and every conditional step on K5's
    one-pass kernel; the image against the twin path in the same mode and
    its agreement with ``high``'s."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                      pad_to_multiple)
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    n_cond = sum(e["kind"] == "step_cond" for e in model.plan)
    kernel_path = SRFlowLPPredictor(model, prior, kernels=True)
    twin_path = SRFlowLPPredictor(model, prior, kernels=False)
    high = kernel_path.predict(lr_img)
    with precision("default"):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        out = kernel_path.predict(lr_img)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        ref = twin_path.predict(lr_img)
        x = pad_to_multiple(lr_img)
        sr, sr_ref = kernel_path.run(x), twin_path.run(x)
    torch.cuda.synchronize()
    want = {"flow_step_bf16_forward": n_cond, "flow_step_bf16_reverse": n_cond,
            "flow_step_forward": 0, "flow_step_reverse": 0,
            "conv3x3_cat_bf16": launches_high["conv3x3_cat"],
            "conv3x3_cat": 0}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong or out.shape != high.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"srflow predict {label} default: launches "
                           f"{launches}, expected {want}")
    twin_db, twin_floor = agreement_db(out, ref), TOL["srflow_default_twin_db"]
    rel = float((sr - sr_ref).abs().max()) / float(sr_ref.abs().max())
    db, floor = agreement_db(out, high), AGREEMENT_FLOOR_DB["srflow default"]
    log(f"srflow predict {label} default: shape {tuple(out.shape)}, finite, "
        f"launches {json.dumps(launches)}; kernel path vs twin path "
        f"{twin_db:.3f} dB (floor {twin_floor:g}), max abs "
        f"{float((out - ref).abs().max()):.3e}, mean abs "
        f"{float((out - ref).abs().mean()):.3e}; unclipped: max |kernel - "
        f"twin| / max |twin| {rel:.3e} (reported)")
    log(f"agreement srflow {label} default vs high: {db:.3f} dB (floor "
        f"{floor:g}), max |default - high| "
        f"{float((out - high).abs().max()):.3e}; twin path vs high "
        f"{agreement_db(ref, high):.3f} dB")
    if not (twin_db >= twin_floor and db >= floor
            and torch.isfinite(sr).all()):
        raise RuntimeError(f"srflow predict {label} default: kernel path vs "
                           f"twin path {twin_db:.3f} dB, agreement {db:.3f} "
                           "dB")
    return launches


def check_srflow_default_pallas(model, prior, lr_img, label, launches_high):
    """K5's ``pallas`` form through its own entry: the flow frozen with
    ``step_form="pallas"``, one ``default`` predict with the launch counters
    reset (that form's K5 48 + 48, the served form's 0), its agreement with
    ``high`` beside the served form's; then the flow frozen back to the
    served form."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    n_cond = sum(e["kind"] == "step_cond" for e in model.plan)
    pred = SRFlowLPPredictor(model, prior)
    high = pred.predict(lr_img)
    with precision("default"):
        served = pred.predict(lr_img)
        model.flowUpsamplerNet.freeze("pallas")
        try:
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            out = pred.predict(lr_img)
            torch.cuda.synchronize()
            launches = dict(cuda.LAUNCHES)
        finally:
            model.flowUpsamplerNet.freeze()
    want = {"flow_step_bf16_pallas_forward": n_cond,
            "flow_step_bf16_pallas_reverse": n_cond,
            "flow_step_bf16_forward": 0, "flow_step_bf16_reverse": 0,
            "conv3x3_cat_bf16": launches_high["conv3x3_cat"]}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong or out.shape != high.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"srflow predict {label} default pallas form: "
                           f"launches {launches}, expected {want}")
    db, floor = (agreement_db(out, high),
                 AGREEMENT_FLOOR_DB["srflow default pallas"])
    log(f"srflow predict {label} default, pallas form: launches "
        f"{json.dumps(launches)}; agreement vs high {db:.3f} dB (floor "
        f"{floor:g}), served xla form vs high {agreement_db(served, high):.3f}"
        f" dB, pallas vs xla form {agreement_db(out, served):.3f} dB")
    if db < floor:
        raise RuntimeError(f"srflow predict {label} default pallas form: "
                           f"agreement {db:.3f} dB")
    return launches


def profile_srflow_stages(model, prior, lr_img, label, reps=3):
    """Device time of each stage of one kernel-path predict (CUDA events
    between the stages, median of ``reps``)."""
    import torch

    from bfsr_tpu_torch.pipelines.srflow_eval import (STAGES,
                                                      SRFlowLPPredictor,
                                                      pad_to_multiple)

    pred = SRFlowLPPredictor(model, prior)
    x = pad_to_multiple(lr_img)
    per = {s: [] for s in STAGES}
    for _ in range(reps):
        marks = []

        def mark(stage, _=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        mark("start")
        pred.run(x, mark)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(marks, marks[1:]):
            per[stage].append(a.elapsed_time(b))
    total = sum(statistics.median(v) for v in per.values())
    log(f"stages {label}: " + ", ".join(
        f"{s} {statistics.median(v):.3f} ms "
        f"({100 * statistics.median(v) / total:.1f}%)" for s, v in per.items())
        + f"; total {total:.3f} ms")


# ---------------------------------------------------------------------------
# LINF-LP, patch model (ps = 3, d = 27)
# ---------------------------------------------------------------------------


def patch_ragged_inputs(dev, seed=0):
    """(inp, coord, cell, gt_lr_up) of a random LR 101x85 / HR 404x340
    pair through the ``sr-implicit-paired-fast-patch`` wrapper: the
    135x114 padded centre grid, with its residual patches."""
    import numpy as np
    import torch

    from bfsr_tpu_torch.data.wrappers import SRImplicitPairedFastPatch, batches

    b = next(batches(SRImplicitPairedFastPatch([random_pair(
        PATCH_RAGGED_LR, 4, seed)])))
    inp = (b["inp"] - 0.5) / 0.5
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (inp, b["coord"], b["cell"], b["gt_lr_up"]))


def random_pair(lr_hw, scale, seed):
    """An (LR, HR) pair of random images in [0, 1], float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hr = rng.random((lr_hw[0] * scale, lr_hw[1] * scale, 3))
    return (rng.random((*lr_hw, 3)).astype(np.float32),
            hr.astype(np.float32))


def check_patch_kernels(model, inputs, ragged_inputs):
    """K2 at out_dim 540 and K4 forward / inverse against their twins at
    the patch path's grids."""
    import torch

    from bfsr_tpu_torch.ops.cuda import linf_flow, linf_info

    results = {}
    flow = model.imnet
    n_layers, d = flow.w.shape[0] - 1, flow.w.shape[-1]
    for tag, (inp, coord, cell, gt) in (("516^2", inputs),
                                        ("ragged", ragged_inputs)):
        with torch.inference_mode():
            feat = model.gen_feat(inp, kernels=False)
            coef, freq = model.head(feat)
            phase = model.phase_of(cell, inp.shape[1], inp.shape[2])
            cy = coord[0, :, 0, 0].contiguous()
            cx = coord[0, 0, :, 1].contiguous()
            args = (coef, freq, cy, cx, phase, model.mlp())
            n = cy.shape[0] * cx.shape[0]
            out_dim = model.mlp()[-1][0].shape[0]
            flops = 2 * n * sum(w.shape[0] * w.shape[1] for w, _ in model.mlp())
            results.setdefault("linf_info", []).append(compare(
                "linf_info",
                lambda: linf_info.affine_info(*args, model.mlp_packed),
                lambda: linf_info.affine_info_plain(*args),
                TOL["linf_info"], flops, f" patch {tag} out_dim={out_dim}",
                nbytes(coef, freq, cy, cx, phase, model.mlp_packed)
                + 4 * out_dim * n, peak=PEAK_3XTF32_FLOPS))
            info = linf_info.affine_info_plain(*args)
            x = gt.reshape(-1, d).contiguous()
            z = linf_flow.flow_forward_plain(flow.w, flow.b, x, info)
            # per query: L + 1 d x d matvecs + bias, and per layer the
            # affine coupling of d channels (sigmoid, scale, shift: ~7)
            k4_flops = n * ((n_layers + 1) * (2 * d * d + d) + 7 * d * n_layers)
            k4_bytes = nbytes(flow.w, flow.b, x, info) + x.numel() * 4
            label = f" patch {tag} N={n} d={d} L={n_layers}"
            results.setdefault("linf_flow_nd_forward", []).append(compare(
                "linf_flow_nd_forward",
                lambda: linf_flow.flow_forward(flow.w, flow.b, x, info),
                lambda: linf_flow.flow_forward_plain(flow.w, flow.b, x, info),
                TOL["linf_flow_nd_forward"], k4_flops, label, k4_bytes))
            results.setdefault("linf_flow_nd_inverse", []).append(compare(
                "linf_flow_nd_inverse",
                lambda: linf_flow.flow_inverse(flow.w_inv, flow.b, z, info),
                lambda: linf_flow.flow_inverse_plain(flow.w_inv, flow.b, z,
                                                     info),
                TOL["linf_flow_nd_inverse"], k4_flops, label, k4_bytes))
    return results


def check_patch_predict(model, prior, inputs, label):
    """The patch path through the kernels vs through the twins."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    inp, coord, cell, gt = inputs
    kernel_path = LINFPredictor(model, prior, kernels=True)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    out = kernel_path.predict(inp, coord, cell, gt)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    ref = LINFPredictor(model, prior, kernels=False).predict(inp, coord, cell,
                                                             gt)
    torch.cuda.synchronize()
    want = (1, 3 * coord.shape[1], 3 * coord.shape[2], 3)
    if tuple(out.shape) != want or not torch.isfinite(out).all():
        raise RuntimeError(f"patch predict {label}: bad output "
                           f"{tuple(out.shape)}, expected {want}")
    wrong = {k: launches[k] for k, v in PATCH_LAUNCHES.items()
             if launches[k] != v}
    if wrong:
        raise RuntimeError(f"patch predict {label}: launches {launches}, "
                           f"expected {PATCH_LAUNCHES}")
    err = float((out - ref).abs().max())
    log(f"patch predict {label}: shape {tuple(out.shape)}, finite, launches "
        f"{json.dumps(launches)}, max |kernel - twin| {err:.3e} (tol "
        f"{TOL['patch_image']:g}), max |out| {float(out.abs().max()):.3f}")
    if not err <= TOL["patch_image"]:
        raise RuntimeError(f"patch predict {label}: kernel path disagrees "
                           f"with the twin path: {err:.3e}")
    return launches


def check_patch_eval(model, prior):
    """eval_psnr over two in-memory pairs (LR 128^2 and 101x85, x4)
    through the patch wrapper, on the kernel and the twin path."""
    import math

    from bfsr_tpu_torch.data.wrappers import SRImplicitPairedFastPatch, batches
    from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr

    pairs = [random_pair(LR, 4, 1), random_pair(PATCH_RAGGED_LR, 4, 2)]
    norm = {"inp": {"sub": [0.5], "div": [0.5]},
            "gt": {"sub": [0.5], "div": [0.5]}}
    psnr = {}
    for path in ("kernel", "twin"):
        t0 = time.perf_counter()
        psnr[path] = eval_psnr(batches(SRImplicitPairedFastPatch(pairs)),
                               model, prior, data_norm=norm,
                               eval_type="benchmark-4", patch=True,
                               kernels=path == "kernel")
        log(f"patch eval_psnr {path} path: {psnr[path]:.6f} dB over "
            f"{len(pairs)} pairs (benchmark-4) in "
            f"{time.perf_counter() - t0:.3f} s")
    diff = abs(psnr["kernel"] - psnr["twin"])
    if not (all(math.isfinite(v) for v in psnr.values())
            and diff <= TOL["patch_psnr_db"]):
        raise RuntimeError(f"patch eval_psnr: kernel {psnr['kernel']} vs "
                           f"twin {psnr['twin']} dB")


# ---------------------------------------------------------------------------
# the native host library
# ---------------------------------------------------------------------------


def host_ms(fn, reps):
    """Median host ms of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def run_native():
    """Phase 18: the native host library against its twins at
    ``NATIVE_SHAPES`` (max abs error and host ms of each), then the loader
    profile (``profiling/loader_times.py``)."""
    import numpy as np

    from bfsr_tpu_torch import native
    from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
    from bfsr_tpu_torch.data.wrappers import residuals, residuals_np
    from bfsr_tpu_torch.ops.imresize import imresize
    from bfsr_tpu_torch.profiling import loader_times

    t0 = time.perf_counter()
    native.library()
    cpu, cores = loader_times.host_cpu()
    log(f"native: {native.SOURCE.relative_to(ROOT)} built and loaded in "
        f"{native.build_seconds:.2f} s; host CPU {cpu!r}, {cores} logical "
        "cores")
    rng = np.random.default_rng(0)
    bad = []
    for label, lr_hw, hr_hw in NATIVE_SHAPES:
        lr = rng.random((*lr_hw, 3)).astype(np.float32)
        hr = rng.random((*hr_hw, 3)).astype(np.float32)
        reps = 3 if hr_hw[0] * hr_hw[1] > 1e6 else 10
        cases = [
            ("residual", lambda: residuals(lr, hr_hw),
             lambda: residuals_np(lr, hr_hw), ("lr_up", "residual")),
            ("bilinear up", lambda: native.bilinear_resize(lr, hr_hw),
             lambda: resize_bilinear_np(lr, hr_hw), ("bilinear",)),
            ("bilinear up align_corners",
             lambda: native.bilinear_resize(lr, hr_hw, True),
             lambda: resize_bilinear_np(lr, hr_hw, True), ("bilinear",)),
            ("bicubic down", lambda: native.bicubic_resize(hr, lr_hw),
             lambda: imresize(hr.astype(np.float64), output_shape=lr_hw),
             ("bicubic",))]
        for name, fn, twin, keys in cases:
            got, ref = fn(), twin()
            got, ref = ((got,), (ref,)) if len(keys) == 1 else (got, ref)
            errs = []
            for k, g, r in zip(keys, got, ref):
                err = (float(np.abs(g - r).max()) if g.shape == r.shape
                       and g.dtype == np.float32 else float("inf"))
                errs.append(err)
                if not (np.isfinite(g).all() and err <= NATIVE_TOL[k]):
                    bad.append(f"{label} {name} {k}: {err:.3e}")
            log(f"native {label} {lr_hw} <-> {hr_hw} {name}: max abs err "
                + ", ".join(f"{k} {e:.3e} (tol {NATIVE_TOL[k]:g})"
                            for k, e in zip(keys, errs))
                + f"; host {host_ms(fn, reps):.3f} ms, twin "
                f"{host_ms(twin, 1 if name == 'bicubic down' else reps):.3f}"
                " ms")
    if bad:
        raise RuntimeError(f"native: disagrees with its twins: {bad}")
    loader_times.run(reps=5, log=log)
    log(f"native: phase 18 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the LINF-LP trainer
# ---------------------------------------------------------------------------


class SyntheticCrops:
    """A dataset of ``n`` synthetic crop-wrapper samples (the crop-patch
    wrapper's with ``patch``), sample i from ``np.random.default_rng(seed
    + i)``."""

    def __init__(self, n, seed=0, patch=False):
        self.n, self.seed, self.patch = n, seed, patch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        from bfsr_tpu_torch.entry import (synthetic_patch_train_sample,
                                          synthetic_train_sample)

        make = (synthetic_patch_train_sample if self.patch
                else synthetic_train_sample)
        return make(np.random.default_rng(self.seed + i), TRAIN_INP,
                    TRAIN_SCALE_MAX)


def check_train_kernels(linf, batch, bf16=False):
    """A trainer's kernel shapes (the pixel model's or, for a patch model,
    the patch trainer's): K3 at the batch's B (the encoder's 64 -> 64 and
    the head's 3 -> 64, beside cuDNN; with ``bf16`` the bf16 K3 too), K2
    over the batch's crops with per-sample axes and cells, K1 / K4 both
    ways on their queries, and the flow inverse's gradient through
    ``FlowInverse`` against autograd through the twin.  Returns {name:
    [results]}."""
    import torch

    from bfsr_tpu_torch.models.linf import grid_axes
    from bfsr_tpu_torch.ops.cuda import linf_flow, linf_info
    from bfsr_tpu_torch.pipelines.linf_train import patch_grid_axes

    ps = linf.patch_size
    tag = "train" if ps == 1 else "patch train"
    gen = torch.Generator(device="cuda").manual_seed(1 if ps == 1 else 2)
    out = {}
    inp = (batch["inp"] - 0.5) / 0.5
    B, n_lr = inp.shape[0], inp.shape[1]
    feat_in = torch.randn((B, n_lr, n_lr, 64), generator=gen, device="cuda")
    enc = linf.encoder
    convs = [(f"{tag} encoder 64->64 B={B} @{n_lr}^2", [feat_in],
              enc.body[0].body[0], enc.body[0].body[0].bias, "relu"),
             (f"{tag} head 3->64 B={B} @{n_lr}^2", [inp], enc.head[0],
              enc.head[0].bias, None)]
    out["conv3x3_cat"] = [check_k3(label, xs, conv, None, b, act)
                          for label, xs, conv, b, act in convs]
    if bf16:
        out["conv3x3_cat_bf16"] = [check_k3_bf16(label, xs, conv, None, b,
                                                 act)
                                   for label, xs, conv, b, act in convs]
    # no_grad, not inference_mode: FlowInverse saves the info for backward
    with torch.no_grad():
        feat = linf.gen_feat(inp, kernels=False)
        coef, freq = linf.head(feat)
        phase = linf.phase_of(batch["cell"], n_lr, n_lr)
        cy, cx = (grid_axes(batch["coord"]) if ps == 1 else patch_grid_axes(
            batch["coord"], batch["interpolate_coord"].shape[1:3], ps))
        args = (coef, freq, cy, cx, phase, linf.mlp())
        n = B * cy.shape[1] * cx.shape[1]
        flops = 2 * n * sum(w.shape[0] * w.shape[1] for w, _ in linf.mlp())
        out_dim = linf.mlp()[-1][0].shape[0]
        label = (f" train B={B} {n_lr}^2 crops" if ps == 1 else
                 f" patch train B={B} {cy.shape[1]}^2 centre grids "
                 f"out_dim={out_dim}")
        out["linf_info"] = [compare(
            "linf_info", lambda: linf_info.affine_info(*args, linf.mlp_packed),
            lambda: linf_info.affine_info_plain(*args), TOL["linf_info"],
            flops, label, nbytes(coef, freq, cy, cx, phase, linf.mlp_packed)
            + 4 * out_dim * n, peak=PEAK_3XTF32_FLOPS)]
        info = linf_info.affine_info_plain(*args)
    # the step's own values: the batch's LR-up residual and its latent
    flow = linf.imnet
    n_layers, d = flow.w.shape[0] - 1, flow.w.shape[-1]
    x = batch["gt_lr_up"].reshape(-1, d).contiguous()
    with torch.no_grad():
        z = linf_flow.flow_forward_plain(flow.w, flow.b, x, info)
    up = torch.randn((n, d), generator=gen, device="cuda")

    def grad(fn):
        zr = z.clone().requires_grad_(True)
        return torch.autograd.grad(fn(flow.w_inv, flow.b, zr, info), zr,
                                   up)[0]

    if d == 3:
        # per query and layer: a 3x3 matvec + bias (21 flop) and the affine
        # coupling of 3 channels (15)
        fwd, inv = "linf_flow_forward", "linf_flow_inverse"
        k_flops = n * (36 * n_layers + 21)
        label = f" train N={n}"
    else:
        # as check_patch_kernels counts them
        fwd, inv = "linf_flow_nd_forward", "linf_flow_nd_inverse"
        k_flops = n * ((n_layers + 1) * (2 * d * d + d) + 7 * d * n_layers)
        label = f" patch train N={n} d={d} L={n_layers}"
    k_bytes = nbytes(flow.w, flow.b, z, info) + z.numel() * 4
    with torch.no_grad():
        out[fwd] = [compare(
            fwd, lambda: linf_flow.flow_forward(flow.w, flow.b, x, info),
            lambda: linf_flow.flow_forward_plain(flow.w, flow.b, x, info),
            TOL[fwd], k_flops, label, k_bytes)]
        inverse = compare(
            inv, lambda: linf_flow.flow_inverse(flow.w_inv, flow.b, z, info),
            lambda: linf_flow.flow_inverse_plain(flow.w_inv, flow.b, z, info),
            TOL[inv], k_flops, label, k_bytes)
    # FlowInverse: z, the info, the weights and the upstream gradient read,
    # x and z's gradient written; the VJP about twice the forward
    out[inv] = [inverse, compare(
        inv, lambda: grad(linf_flow.flow_inverse_diff),
        lambda: grad(linf_flow.flow_inverse_plain),
        TRAIN_TOL["flow_inverse_grad"], 3 * k_flops,
        f" gradient (FlowInverse) N={n}" + ("" if d == 3 else f" d={d}"),
        nbytes(flow.w_inv, flow.b, z, info, up) + 2 * z.numel() * 4)]
    return out


def grad_errors(grads, ref):
    """Per tensor: (relative L2 error, error relative to the largest
    |ref|) of ``grads`` against ``ref``."""
    out = {}
    for name, g in grads.items():
        d = g - ref[name]
        out[name] = (float(d.norm() / ref[name].norm().clamp_min(1e-30)),
                     float(d.abs().max() / ref[name].abs().max()
                           .clamp_min(1e-30)))
    return out


def global_rel_l2(grads, ref):
    """Relative L2 error of all of ``grads`` against ``ref``, as one
    vector."""
    import torch

    g = torch.cat([v.flatten() for v in grads.values()])
    r = torch.cat([ref[k].flatten() for k in grads])
    return float((g - r).norm() / r.norm())


def frozen_launch_checks(linf, batch, fz, label):
    """A step's frozen part in the current mode, launch by launch on the
    kernel path's own values ``fz`` (``step.frozen``): each of the
    encoder's K3 launches (34 for EDSR, 345 for the RRDB; the bf16 K3
    under default) against its twin
    on that launch's input, K2 against its twin on the encoder's output
    fz['feat'], and the LR-up residual's flow forward (K1, or K4 at d =
    27) against its twin at fz['info']; each within its kernel's own
    tolerance (TOL).  Returns a line for the log."""
    import torch

    from bfsr_tpu_torch.models.linf import grid_axes
    from bfsr_tpu_torch.ops import nn as fnn
    from bfsr_tpu_torch.ops.cuda import conv3x3, linf_flow
    from bfsr_tpu_torch.pipelines.linf_train import patch_grid_axes

    worst = {}

    def hold(name, got, ref, tol):
        ok, err, tol_s = within(got, ref, tol)
        if not ok:
            raise RuntimeError(f"{label}: {name} on the step's own values "
                               f"disagrees with its twin: max abs err "
                               f"{err:.3e} ({tol_s}), max |ref| "
                               f"{float(ref.abs().max()):.3e}")
        n, e, _ = worst.get(name, (0, 0.0, tol_s))
        worst[name] = (n + 1, max(e, err), tol_s)

    def conv(t, m, act):
        # EDSR's hook passes a tensor, the RRDB's a dense block's inputs
        xs = t if isinstance(t, list) else [t]
        bf16 = fnn.bf16_stage()
        y = conv3x3.conv3x3_cat(xs, m.weight, bias=m.bias, act=act,
                                kweight=m.kweight,
                                kweight_bf16=m.kweight_bf16)
        hold("conv3x3_cat_bf16" if bf16 else "conv3x3_cat", y,
             conv3x3.conv3x3_cat_twin(xs, m.weight, bias=m.bias, act=act),
             TOL["conv3x3_cat_bf16" if bf16 else "conv3x3_cat"])
        return y

    with torch.no_grad():
        feat = linf.encoder(fz["inp"], conv=conv)
        ps, d = linf.patch_size, linf.dim
        cy, cx = (grid_axes(batch["coord"]) if ps == 1 else patch_grid_axes(
            batch["coord"], batch["interpolate_coord"].shape[1:3], ps))
        hold("linf_info", fz["info"], linf.affine_info_grid(
            fz["feat"], cy, cx, batch["cell"], kernels=False),
            TOL["linf_info"])
        fwd = "linf_flow_forward" if d == 3 else "linf_flow_nd_forward"
        hold(fwd, fz["z_lr"].reshape(-1, d), linf_flow.flow_forward_plain(
            linf.imnet.w, linf.imnet.b,
            batch["gt_lr_up"].reshape(-1, d).contiguous(), fz["info"]),
            TOL[fwd])
    return (f"frozen part launch by launch: "
            + ", ".join(f"{k} x {n} max abs err {e:.3e} ({t})"
                        for k, (n, e, t) in worst.items())
            + f"; the checked encoder's output equals the step's: "
            f"{torch.equal(feat, fz['feat'])}")


def _worst(e, i):
    name = max(e, key=lambda k: e[k][i])
    return f"{e[name][i]:.3e} ({name})"


def hold_step(label, kmets, kgrads, ref, ref_grads, nudged_grads, nudged,
              held=""):
    """Hold one step's loss and gradients on the kernel path (``kmets``,
    ``kgrads``) against the twin path's (``ref``, ``ref_grads``).  In high
    (``nudged_grads``: a list of the twin path's gradients with its input
    ``nudged`` scaled by 1 + GRAD_NUDGE or another factor of that size) to
    TRAIN_TOL and the twin path's own spread, the largest over the list;
    in a bf16 mode (``nudged_grads`` None) to MODE_TRAIN_TOL and GRAD_CAP.
    Logs the result, raises past a limit."""
    import torch

    loss, ref_loss = float(kmets["loss"]), float(ref["loss"])
    rel = abs(loss - ref_loss) / abs(ref_loss)
    errs = grad_errors(kgrads, ref_grads)
    err_all = global_rel_l2(kgrads, ref_grads)
    if nudged_grads is None:
        loss_tol, tol, tol_all = MODE_TRAIN_TOL["loss_rel"], GRAD_CAP, GRAD_CAP
        part = " (the trainable part from the kernel path's frozen values)"
    else:
        def limit(s):
            return min(GRAD_CAP, max(GRAD_FLOOR, GRAD_SPREAD_FACTOR * s))

        spreads = [grad_errors(g, ref_grads) for g in nudged_grads]
        spread = {k: tuple(max(sp[k][i] for sp in spreads) for i in (0, 1))
                  for k in spreads[0]}
        loss_tol = TRAIN_TOL["loss_rel"]
        tol = limit(max(v[0] for v in spread.values()))
        tol_all = limit(max(global_rel_l2(g, ref_grads)
                            for g in nudged_grads))
        part = ""
        held = (f"; the twin path's own spread ({nudged}): worst relative L2 "
                f"{_worst(spread, 0)}, median "
                f"{statistics.median(v[0] for v in spread.values()):.3e}, "
                f"worst of max |g| {_worst(spread, 1)}")
    if not all(torch.isfinite(g).all() for g in kgrads.values()):
        raise RuntimeError(f"{label}: a gradient is not finite")
    bad = {k: v[0] for k, v in errs.items() if not v[0] <= tol}
    if bad or not rel <= loss_tol or not err_all <= tol_all:
        raise RuntimeError(f"{label}: loss {loss!r} vs twin path "
                           f"{ref_loss!r} ({rel:.3e} relative, at most "
                           f"{loss_tol:.3e}); gradients past {tol:.3e} "
                           f"relative L2: {bad}; all gradients {err_all:.3e} "
                           f"relative L2 (at most {tol_all:.3e})")
    log(f"{label}: kernel path{part} loss {loss!r} vs twin path "
        f"{ref_loss!r}: {rel:.3e} relative (at most {loss_tol:.3e}); "
        f"{len(kgrads)} gradient tensors against the twin path: worst "
        f"relative L2 {_worst(errs, 0)}, median "
        f"{statistics.median(v[0] for v in errs.values()):.3e}, worst of max "
        f"|g| {_worst(errs, 1)}; tolerance {tol:.3e} relative L2; all "
        f"gradients as one vector {err_all:.3e} relative L2 (at most "
        f"{tol_all:.3e}){held}")


def train_step_check(linf, prior, vgg, batch, latent_weight, want=None,
                     label="train step", mode=None):
    """One step's loss and gradients on the kernel path, with the launch
    counters reset first (``want``: the launches expected, by default
    TRAIN_LAUNCHES with K1's forward twice under the latent loss), against
    the twin path from the same state.  In high (``mode`` None) both paths
    run the whole step, held to the twin's spread under ``gt_lr_up``
    nudged (TRAIN_TOL); in a bf16 mode the frozen part is held launch by
    launch (``frozen_launch_checks``) and the trainable part runs on both
    paths from the kernel path's frozen values (MODE_TRAIN_TOL).  Returns
    (the kernel path's launches, its loss, its gradients)."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step, to_device
    from bfsr_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    label = f"{label} latent_weight={latent_weight:g}"
    if want is None:
        want = dict(TRAIN_LAUNCHES)
        if latent_weight > 0:
            want["linf_flow_forward"] = 2
    batch = to_device(batch, "cuda")
    with precision(mode or "high"):
        step = make_train_step(linf, prior, vgg, opt,
                               latent_weight=latent_weight)
        twin = make_train_step(linf, prior, vgg, opt,
                               latent_weight=latent_weight, kernels=False)
        cuda.reset_launch_counts()
        mets, grads, _ = step.loss_and_grads(batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if launches != want:
            raise RuntimeError(f"{label}: launches {launches}, expected "
                               f"{want}")
        held = ""
        if mode:
            fz = step.frozen(batch)
            held = "; " + frozen_launch_checks(linf, batch, fz, label)
            kmets, kgrads, _ = step.loss_and_grads(batch, frozen=fz)
            ref, ref_grads, _ = twin.loss_and_grads(batch, frozen=fz)
        else:
            kmets, kgrads = mets, grads
            ref, ref_grads, _ = twin.loss_and_grads(batch)
            nudged = twin.loss_and_grads(dict(
                batch, gt_lr_up=batch["gt_lr_up"] * (1 + GRAD_NUDGE)))

    hold_step(label, kmets, kgrads, ref, ref_grads,
              None if mode else [nudged[1]],
              f"gt_lr_up x {1 + GRAD_NUDGE:.9g}", held)
    log(f"{label}: launches {launches}; loss {float(mets['loss'])!r} (vgg_l "
        f"{float(mets['vgg_l'])!r}, latent_l {float(mets['latent_l'])!r})")
    return launches, float(mets["loss"]), grads


def time_steps(steps, label, blocks=3, per_block=5):
    """ms/step of each path (name -> step fn), 2 warm-ups each, blocks
    interleaved as in ``time_paths``."""
    import torch

    for fn in steps.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in steps}
    names = list(steps)
    for k in [k for b in range(blocks)
              for k in (names if b % 2 == 0 else names[::-1])]:
        t0 = time.perf_counter()
        for _ in range(per_block):
            steps[k]()
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) * 1e3 / per_block)
    out = {}
    for k, ts in times.items():
        med, best = statistics.median(ts), min(ts)
        out[k] = med
        log(f"time {label} {k} path: median {med:.3f} ms/step, best "
            f"{best:.3f} ms/step, {1e3 / med:.3f} steps/s (median), "
            f"{1e3 / best:.3f} (best); blocks {[round(t, 3) for t in ts]}")
    return out


def train_stages(make_step, batch, label, reps=3):
    """A step split into its stages by CUDA events at the step's marks:
    the median over ``reps`` steps of each stage's time between events.
    ``make_step(marks)`` builds the step."""
    import torch

    events = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    step = make_step(mark)
    split = {}
    for _ in range(reps):
        events.clear()
        step(batch)
        torch.cuda.synchronize()
        for (name, a), (_, b) in zip(events, events[1:]):
            split.setdefault(name, []).append(a.elapsed_time(b))
    med = {k: statistics.median(v) for k, v in split.items()}
    total = sum(med.values())
    log(f"stages {label}: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in med.items())
        + f"; total {total:.3f} ms")
    return med


def run_trainer(dev):
    """Phase 10: the LINF-LP trainer at its full configuration."""
    from bfsr_tpu_torch.entry import (build_flagship_trainer,
                                      example_train_batch)

    t0 = time.perf_counter()
    linf, prior, vgg = build_flagship_trainer(dev, seed=0)
    batches = [example_train_batch(dev, seed, TRAIN_BATCH, TRAIN_INP,
                                   TRAIN_SCALE_MAX) for seed in range(4)]
    log(f"train: models and 4 synthetic batches of {TRAIN_BATCH} x "
        f"{TRAIN_INP}^2 (scales U(1, {TRAIN_SCALE_MAX})) built in "
        f"{time.perf_counter() - t0:.2f} s; prior "
        f"{sum(p.numel() for p in prior.parameters())} parameters")
    checks = check_train_kernels(linf, batches[0], bf16=True)
    launches = train_step_check(linf, prior, vgg, batches[0], 0.0)[0]
    train_step_check(linf, prior, vgg, batches[1], 1.0)
    exercise_trainer(linf, prior, vgg, batches, "train",
                     f"B={TRAIN_BATCH} {TRAIN_INP}^2")
    return checks, launches, (linf, prior, vgg), batches


def exercise_trainer(linf, prior, vgg, batches, tag, shape, patch=False):
    """20 kernel-path steps (finite losses, every parameter moved, peak
    memory), steps/s on resident batches (kernel and twin paths
    interleaved) and fed by the port's ``DataLoader``, the stage split of
    both paths and one profiled step."""
    import numpy as np
    import torch

    from bfsr_tpu_torch.data.loader import DataLoader
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.profiling.loader_times import residual_path
    from bfsr_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    steps = {k: make_train_step(linf, prior, vgg, opt, kernels=k == "kernel")
             for k in ("twin", "kernel")}
    before = {k: v.detach().clone() for k, v in prior.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = [steps["kernel"](batches[i % 4])["loss"] for i in range(20)]
    peak = torch.cuda.max_memory_allocated()
    still = [k for k, v in prior.named_parameters()
             if torch.equal(v, before[k])]
    if not np.isfinite(losses).all() or still:
        raise RuntimeError(f"{tag}: 20 steps: losses {losses}, parameters "
                           f"that did not move: {still}")
    log(f"{tag}: 20 kernel-path steps: loss {losses[0]!r} at step 1, "
        f"{losses[-1]!r} at step 20 (not gated: random VGG); every one of "
        f"{len(before)} parameter tensors moved; peak memory "
        f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the "
        f"{base / 2**20:.1f} MiB resident)")

    it = iter(range(10 ** 9))
    medians = time_steps({k: (lambda s=s: s(batches[next(it) % 4]))
                          for k, s in steps.items()},
                         f"{tag} {shape} resident")
    # loader-fed: the samples' residuals from the native host library (as
    # every wrapper computes them), then from its numpy twin
    for residual in ("native", "numpy"):
        with residual_path(residual):
            loader = DataLoader(SyntheticCrops(10 * TRAIN_BATCH, patch=patch),
                                TRAIN_BATCH, shuffle=True, num_workers=4,
                                seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in loader:
                steps["kernel"](b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log(f"time {tag} B={TRAIN_BATCH} loader-fed kernel path, residual "
            f"{residual}: 10 steps in {wall * 1e3:.3f} ms, {10 / wall:.3f} "
            f"steps/s ({wall * 100:.3f} ms/step; the DataLoader's 4 threads "
            f"making the batches); resident {1e3 / medians['kernel']:.3f} "
            "steps/s")
    for k in ("kernel", "twin"):
        train_stages(lambda marks, k=k: make_train_step(
            linf, prior, vgg, opt, kernels=k == "kernel", marks=marks),
            batches[0], f"{tag} B={TRAIN_BATCH} {k} path")
    profile_predict(lambda: steps["kernel"](batches[0]), medians["kernel"],
                    f"{tag} B={TRAIN_BATCH} step", top=16, what="step")
    return medians


# ---------------------------------------------------------------------------
# the LINF-LP patch trainer and training under the bf16 modes
# ---------------------------------------------------------------------------


def run_patch_trainer(dev):
    """Phase 11, first part: the LINF-LP patch trainer (``--patch 3``) at
    its full configuration.  Returns (checks, launches, models, batches)."""
    from bfsr_tpu_torch.entry import (build_patch_trainer,
                                      example_patch_train_batch)

    t0 = time.perf_counter()
    linf, prior, vgg = build_patch_trainer(dev, seed=0)
    batches = [example_patch_train_batch(dev, seed, TRAIN_BATCH, TRAIN_INP,
                                         TRAIN_SCALE_MAX)
               for seed in range(4)]
    n_lr = batches[0]["inp"].shape[1]
    log(f"patch train: models and 4 synthetic batches of {TRAIN_BATCH} x "
        f"{n_lr}^2 LR crops ({TRAIN_INP}^2 patch centres, scales U(1, "
        f"{TRAIN_SCALE_MAX})) built in {time.perf_counter() - t0:.2f} s; "
        f"prior {sum(p.numel() for p in prior.parameters())} parameters")
    checks = check_train_kernels(linf, batches[0], bf16=True)
    want = dict(PATCH_TRAIN_LAUNCHES)
    launches = train_step_check(linf, prior, vgg, batches[0], 0.0, want,
                                "patch train step")[0]
    want["linf_flow_nd_forward"] = 2
    train_step_check(linf, prior, vgg, batches[1], 1.0, want,
                     "patch train step")
    exercise_trainer(linf, prior, vgg, batches, "patch train",
                     f"B={TRAIN_BATCH} {n_lr}^2", patch=True)
    return checks, launches, (linf, prior, vgg), batches


def mode_launches(want, mode):
    """A step's launches under ``mode``: the encoder's K3 on the bf16
    kernel under default; the prior trains on plain convs in every
    mode."""
    if mode != "default":
        return dict(want)
    out = {k: v for k, v in want.items() if k != "conv3x3_cat"}
    out["conv3x3_cat_bf16"] = want["conv3x3_cat"]
    return out


def run_train_modes(trainers):
    """Phase 11, second part: both trainers under mixed and default.  Per
    trainer and mode one step's loss and gradients on the kernel and twin
    paths in that mode (``train_step_check``), its loss against the kernel
    path's in high on the same batch and state (MODE_TRAIN_TOL; high's own
    check against the twin path is phase 10's and the first part's), then
    high, mixed and default timed interleaved.  ``trainers``: {name:
    (models, batches, launches in high)}.  Returns {path: launches}."""
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    out = {}
    for name, ((linf, prior, vgg), batches, want) in trainers.items():
        shape = f"B={TRAIN_BATCH} {batches[0]['inp'].shape[1]}^2"
        opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                             prior.parameters())
        step = make_train_step(linf, prior, vgg, opt)
        with precision("high"):
            mets, high_grads, _ = step.loss_and_grads(batches[0])
        high = float(mets["loss"])
        for mode in ("mixed", "default"):
            launches, loss, grads = train_step_check(
                linf, prior, vgg, batches[0], 0.0, mode_launches(want, mode),
                f"{name} step {mode}", mode=mode)
            out[f"{name.replace(' ', '_')}_{mode}"] = launches
            rel = abs(loss - high) / abs(high)
            if not rel <= MODE_TRAIN_TOL["vs_high_rel"]:
                raise RuntimeError(f"{name} step {mode}: loss {loss!r} vs "
                                   f"high's {high!r}: {rel:.3e} relative "
                                   f"(at most "
                                   f"{MODE_TRAIN_TOL['vs_high_rel']:g})")
            log(f"{name} step {mode} vs high on the same batch: loss {loss!r} "
                f"vs {high!r}, {rel:.3e} relative (at most "
                f"{MODE_TRAIN_TOL['vs_high_rel']:g}); all gradients "
                f"{global_rel_l2(grads, high_grads):.3e} relative L2 (not "
                f"gated)")
        it = iter(range(10 ** 9))
        time_steps({m: in_mode(m, lambda: step(batches[next(it) % 4]))
                    for m in ("high", "mixed", "default")},
                   f"{name} {shape} mode")
    return out


# ---------------------------------------------------------------------------
# the SRFlow-LP prior trainer
# ---------------------------------------------------------------------------

# configs/srflow/SRFlow-LP_DF2K_4X.yml's train section, as the prior
# trainer reads it (srflow_train.py --prior): batch 12 of 160^2 GT crops
# (40^2 LQ), Adam at lr_G 2.5e-4 with betas (0.9, 0.99), MultiStepLR at
# lr_steps_rel over niter, weight_eps 1 and weight_img 0 (the CLI's
# defaults)
SRFLOW_TRAIN_BATCH, SRFLOW_TRAIN_GT = 12, 160
SRFLOW_TRAIN_OPT = {"lr_G": 2.5e-4, "beta1": 0.9, "beta2": 0.99,
                    "lr_scheme": "MultiStepLR", "warmup_iter": -1,
                    "lr_steps_rel": [0.5, 0.75, 0.9, 0.95], "lr_gamma": 0.5,
                    "niter": 70000}

def srflow_train_launches(model, mode, image_weight):
    """A prior-trainer step's launches in ``mode``: the RRDB's dense-block
    convs on K3 (the bf16 K3 under default), the conditional steps' K5
    forwards in both encodes and, with the image loss, their reverses in
    the decode (the one-pass form under default)."""
    n_k3 = 15 * len(model.RRDB.RRDB_trunk)
    n_cond = sum(e["kind"] == "step_cond" for e in model.plan)
    bf16 = mode == "default"
    k5 = "flow_step_bf16" if bf16 else "flow_step"
    out = {"conv3x3_cat_bf16" if bf16 else "conv3x3_cat": n_k3,
           f"{k5}_forward": 2 * n_cond}
    if image_weight > 0:
        out[f"{k5}_reverse"] = n_cond
    return out


def write_lrhr_pickles(root, n, seed=0):
    """``lrhr-pkl`` pickles of ``n`` synthetic samples (sample i from
    ``np.random.default_rng(seed + i)``, quantised to uint8 as the
    reference's pickles hold them) under ``root``: {'GT', 'LQ'} paths."""
    import pickle

    import numpy as np

    from bfsr_tpu_torch.entry import synthetic_lrhr_sample

    samples = [synthetic_lrhr_sample(np.random.default_rng(seed + i),
                                     SRFLOW_TRAIN_GT) for i in range(n)]
    paths = {}
    for k in ("GT", "LQ"):
        paths[k] = str(Path(root) / f"{k}.pklv4")
        with open(paths[k], "wb") as f:
            pickle.dump([np.round(s[k] * 255).astype(np.uint8)
                         for s in samples], f)
    return paths


def srflow_adam(params):
    """(a fresh Adam over ``params``, its LR scheduler) at the flagship
    conf's optimizer and schedule."""
    from bfsr_tpu_torch.cli.srflow_train import make_schedule
    from bfsr_tpu_torch.train.optim import lr_scheduler, make_optimizer

    t = SRFLOW_TRAIN_OPT
    opt = make_optimizer({"name": "adam", "args": {
        "lr": t["lr_G"], "betas": (t["beta1"], t["beta2"])}}, params)
    return opt, lr_scheduler(opt, make_schedule(t, t["niter"], t["lr_G"]),
                             t["lr_G"])


def srflow_train_step(model, prior, image_weight=0.0, kernels=True,
                      marks=None):
    """The prior trainer's step at the flagship's optimizer and schedule
    (a fresh Adam over the prior's parameters)."""
    from bfsr_tpu_torch.pipelines.srflow_prior_train import (
        make_srflow_prior_train_step)

    opt, sched = srflow_adam(prior.parameters())
    return make_srflow_prior_train_step(model, prior, opt, 1.0, image_weight,
                                        kernels, sched, marks)


def check_srflow_train_kernels(model, batch):
    """The prior trainer's kernel shapes: K5 at B = 12 at each level's
    shape (the first conditional step of each level on its records for
    the batch's LQ), forward and reverse, f32 and the served one-pass
    form, against their twins (the bound from ``k5_cost`` over the whole
    batch; no library call computes a FlowStep); FlowStepReverse's
    gradient against autograd through the twin in both forms; and both
    K3s at the RRDB's conv4 and conv5 over the batch's LQ, beside cuDNN.
    Returns {name: [results]}."""
    import torch

    from bfsr_tpu_torch.ops.cuda import flow_step as k5

    gen = torch.Generator(device="cuda").manual_seed(5)
    lq = batch["LQ"]
    B = lq.shape[0]
    out = {}
    for mode in ("high", "default"):
        with precision(mode):
            for e, step, rec in first_steps(model, lq):
                c, hid = e["c"], step.hidden
                hw = rec.shape[1:3]
                if mode == "high":
                    pk, form, peak = step.kpacked, "f32", PEAK_F32_FLOPS
                    fwd = ("flow_step_forward", k5.flow_step_forward_plain)
                    rev = ("flow_step_reverse", k5.flow_step_reverse_plain)
                else:
                    pk, form = step.kpacked_bf16, step.step_form
                    peak = PEAK_BF16_FLOPS
                    fwd = k5.BF16_FORMS[step.step_form, False]
                    rev = k5.BF16_FORMS[step.step_form, True]
                x = torch.randn((B, *hw, c), generator=gen, device="cuda")
                up = torch.randn((B, *hw, c), generator=gen, device="cuda")
                cost = k5.k5_cost(c, hid, (B * hw[0], hw[1]), pk, form)
                label = (f" train {mode} B={B} level {e['level']} ({hw[0]}, "
                         f"{hw[1]}, {c})")
                with torch.no_grad():
                    y = fwd[1](x, rec, pk, hid)
                    for (name, plain), fn, inp in (
                            (fwd, k5.flow_step_forward, x),
                            (rev, k5.flow_step_reverse, y)):
                        out.setdefault(name, []).append(compare(
                            name, lambda: fn(inp, rec, step.kpacked, hid,
                                             step.kpacked_bf16,
                                             step.step_form),
                            lambda: plain(inp, rec, pk, hid), TOL[name],
                            label=label, cost=cost))

                def grad(f):
                    yr = y.clone().requires_grad_(True)
                    return torch.autograd.grad(
                        f(yr, rec, step.kpacked, hid, step.kpacked_bf16,
                          step.step_form), yr, up)[0]

                # the VJP about twice the forward; y, the records, the
                # weights and the upstream gradient read, x and its
                # gradient written
                out[rev[0]].append(compare(
                    rev[0], lambda: grad(k5.flow_step_reverse_diff),
                    lambda: grad(k5.flow_step_reverse_twin),
                    TOL[f"{rev[0]}_grad"], 3 * cost["flops"],
                    f" gradient (FlowStepReverse){label}",
                    cost["bytes"] + 2 * nbytes(y), peak=peak))
    cases = rrdb_k3_cases(model, lq)
    out["conv3x3_cat"] = [check_k3(*case) for case in cases]
    out["conv3x3_cat_bf16"] = [check_k3_bf16(*case) for case in cases]
    return out


def walk_encode(model, x, cache, hold):
    """The flow encode of ``x`` on the kernel path, each conditional step
    held (``hold(step, x, rec, y)``) as it launches; returns the epses."""
    from bfsr_tpu_torch.ops import flows

    epses = []
    for e, m, rec in zip(model.plan, model.flowUpsamplerNet.layers, cache):
        if e["kind"] == "squeeze":
            x = flows.squeeze2d(x)
        elif e["kind"] == "split":
            x, eps = flows.split2d(x, m)
            epses.append(eps)
        else:
            y = m.forward_step(x, rec, True)
            if m.affine is not None:
                hold(m, x, rec, y)
            x = y
    return epses + [x]


def srflow_frozen_launch_checks(model, batch, fz, label):
    """A prior-trainer step's frozen part in the current mode, launch by
    launch: each of the RRDB's dense-block K3 launches against its twin
    on that launch's input, then each K5 forward of both encodes against
    its twin on that launch's input and record (the step's own records,
    ``fz['cache']``), each within its kernel's own tolerance (TOL).
    Returns a line for the log."""
    import torch

    from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
    from bfsr_tpu_torch.models.unet import k3, k3_twin
    from bfsr_tpu_torch.ops import nn as fnn
    from bfsr_tpu_torch.ops.cuda import TWINS
    from bfsr_tpu_torch.ops.interp import resize_bilinear

    worst = {}

    def hold(name, got, ref):
        ok, err, tol_s = within(got, ref, TOL[name])
        if not ok:
            raise RuntimeError(f"{label}: {name} on the step's own values "
                               f"disagrees with its twin: max abs err "
                               f"{err:.3e} ({tol_s}), max |ref| "
                               f"{float(ref.abs().max()):.3e}")
        n, e, _ = worst.get(name, (0, 0.0, tol_s))
        worst[name] = (n + 1, max(e, err), tol_s)

    bf16 = fnn.bf16_stage()

    def conv(blocks, m, act):
        y = k3(blocks, m, act)
        hold("conv3x3_cat_bf16" if bf16 else "conv3x3_cat", y,
             k3_twin(blocks, m, act))
        return y

    def step(m, x, rec, y):
        hold("flow_step_bf16_forward" if bf16 else "flow_step_forward", y,
             m.forward_step(x, rec, TWINS))

    with torch.no_grad():
        lq, s = batch["LQ"], model.scale
        cache = model.precompute_ft(model.rrdb_preprocess(lq, conv=conv))
        same = all(torch.equal(a, b) for a, b in zip(cache, fz["cache"])
                   if a is not None)
        lr_up = resize_bilinear(lq, (lq.shape[1] * s, lq.shape[2] * s))
        eps_in = standardize_epses(walk_encode(model, lr_up, fz["cache"],
                                               step))
        eps_gt = walk_encode(model, batch["GT"], fz["cache"], step)
    same_eps = all(torch.equal(a, b) for a, b in
                   zip(eps_in + eps_gt, fz["eps_in"] + fz["eps_gt"]))
    return (f"frozen part launch by launch: "
            + ", ".join(f"{k} x {n} max abs err {e:.3e} ({t})"
                        for k, (n, e, t) in worst.items())
            + f"; the checked records equal the step's: {same}; the checked "
            f"epses equal the step's: {same_eps}")


def srflow_train_step_check(model, prior, batch, image_weight, mode=None):
    """One prior-trainer step's loss and gradients on the kernel path,
    with the launch counters reset first (``srflow_train_launches``),
    against the twin path from the same state, held as
    ``train_step_check`` holds the LINF trainers': in high the whole step
    on both paths, to the twin path's spread under LQ scaled by 1 + 1e-7
    and by 1 - 1e-7, the larger (TRAIN_TOL);
    in a bf16 mode the frozen part launch by launch and the trainable part
    on both paths from the kernel path's frozen values (MODE_TRAIN_TOL).
    Returns (the kernel path's launches, its loss, its gradients)."""
    import torch

    from bfsr_tpu_torch.ops import cuda

    label = (f"srflow train step{' ' + mode if mode else ''} eps_weight=1 "
             f"image_weight={image_weight:g}")
    want = srflow_train_launches(model, mode or "high", image_weight)
    with precision(mode or "high"):
        step = srflow_train_step(model, prior, image_weight)
        twin = srflow_train_step(model, prior, image_weight, kernels=False)
        cuda.reset_launch_counts()
        mets, grads, _ = step.loss_and_grads(batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if launches != want:
            raise RuntimeError(f"{label}: launches {launches}, expected "
                               f"{want}")
        held, nudged = "", None
        if mode:
            fz = step.frozen(batch)
            held = "; " + srflow_frozen_launch_checks(model, batch, fz, label)
            kmets, kgrads, _ = step.loss_and_grads(batch, frozen=fz)
            ref, ref_grads, _ = twin.loss_and_grads(batch, frozen=fz)
        else:
            kmets, kgrads = mets, grads
            ref, ref_grads, _ = twin.loss_and_grads(batch)
            nudged = [twin.loss_and_grads(dict(
                batch, LQ=batch["LQ"] * (1 + sign * GRAD_NUDGE)))[1]
                for sign in (1, -1)]
    hold_step(label, kmets, kgrads, ref, ref_grads, nudged,
              f"the larger of LQ x (1 +- {GRAD_NUDGE:g})", held)
    log(f"{label}: launches {launches}; "
        + ", ".join(f"{k} {float(v)!r}" for k, v in mets.items()))
    return launches, float(mets["loss"]), grads


def run_srflow_trainer(dev):
    """Phase 12: the SRFlow-LP prior trainer at its full configuration.
    Returns (checks, {path: launches})."""
    import tempfile

    import numpy as np
    import torch

    from bfsr_tpu_torch.data.loader import DataLoader
    from bfsr_tpu_torch.data.pkl_dataset import LRHRPkl
    from bfsr_tpu_torch.entry import (build_srflow_prior_trainer,
                                      example_srflow_train_batch)

    t0 = time.perf_counter()
    model, prior = build_srflow_prior_trainer(dev, seed=0)
    batches = [example_srflow_train_batch(dev, seed, SRFLOW_TRAIN_BATCH,
                                          SRFLOW_TRAIN_GT)
               for seed in range(4)]
    log(f"srflow train: models and 4 synthetic batches of "
        f"{SRFLOW_TRAIN_BATCH} x {SRFLOW_TRAIN_GT}^2 GT (LQ "
        f"{SRFLOW_TRAIN_GT // 4}^2) built in {time.perf_counter() - t0:.2f} "
        f"s; prior {sum(p.numel() for p in prior.parameters())} parameters; "
        f"flow actnorms unprimed: "
        f"{model.flowUpsamplerNet.actnorms_unprimed()} (the live init)")
    checks = check_srflow_train_kernels(model, batches[0])
    launches = {}
    launches["srflow_train"] = srflow_train_step_check(
        model, prior, batches[0], 0.0)[0]
    launches["srflow_train_image"] = srflow_train_step_check(
        model, prior, batches[1], 1.0)[0]

    # 20 steps on the kernel path (the flagship's losses: eps only)
    step = srflow_train_step(model, prior)
    before = {k: v.detach().clone() for k, v in prior.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = [step(batches[i % 4])["loss"] for i in range(20)]
    peak = torch.cuda.max_memory_allocated()
    still = [k for k, v in prior.named_parameters()
             if torch.equal(v, before[k])]
    if not np.isfinite(losses).all() or still:
        raise RuntimeError(f"srflow train: 20 steps: losses {losses}, "
                           f"parameters that did not move: {still}")
    log(f"srflow train: 20 kernel-path steps: eps_l {losses[0]!r} at step 1, "
        f"{losses[-1]!r} at step 20; every one of {len(before)} parameter "
        f"tensors moved; peak memory {peak / 2**20:.1f} MiB "
        f"({(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB "
        "resident)")

    shape = f"B={SRFLOW_TRAIN_BATCH} {SRFLOW_TRAIN_GT}^2"
    steps = {"twin": srflow_train_step(model, prior, kernels=False),
             "kernel": step,
             "kernel image loss": srflow_train_step(model, prior, 1.0)}
    it = iter(range(10 ** 9))
    medians = time_steps({k: (lambda s=s: s(batches[next(it) % 4]))
                          for k, s in steps.items()},
                         f"srflow train {shape} resident")
    with tempfile.TemporaryDirectory() as root:
        paths = write_lrhr_pickles(root, 10 * SRFLOW_TRAIN_BATCH)
        dataset = LRHRPkl(paths["GT"], paths["LQ"], use_flip=True,
                          gt_size=SRFLOW_TRAIN_GT)
        loader = DataLoader(dataset, SRFLOW_TRAIN_BATCH, shuffle=True,
                            drop_last=True, num_workers=3, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in loader:
            step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"time srflow train {shape} loader-fed kernel path: 10 steps in "
        f"{wall * 1e3:.3f} ms, {10 / wall:.3f} steps/s ({wall * 100:.3f} "
        f"ms/step; the DataLoader's 3 threads reading lrhr-pkl pickles, "
        f"flips on)")
    for k in ("kernel", "twin"):
        train_stages(lambda marks, k=k: srflow_train_step(
            model, prior, 1.0, kernels=k == "kernel", marks=marks),
            batches[0], f"srflow train {shape} image loss {k} path")
    profile_predict(lambda: step(batches[0]), medians["kernel"],
                    f"srflow train {shape} step", top=16, what="step")
    profile_predict(lambda: steps["kernel image loss"](batches[0]),
                    medians["kernel image loss"],
                    f"srflow train {shape} image loss step", top=16,
                    what="step")

    # the bf16 modes: both losses, so that the decode's reverses run too
    with precision("high"):
        high = float(srflow_train_step(model, prior, 1.0).loss_and_grads(
            batches[0])[0]["loss"])
    for mode in ("mixed", "default"):
        launches[f"srflow_train_{mode}"], loss, _ = srflow_train_step_check(
            model, prior, batches[0], 1.0, mode)
        rel = abs(loss - high) / abs(high)
        if not rel <= MODE_TRAIN_TOL["vs_high_rel"]:
            raise RuntimeError(f"srflow train step {mode}: loss {loss!r} vs "
                               f"high's {high!r}: {rel:.3e} relative (at "
                               f"most {MODE_TRAIN_TOL['vs_high_rel']:g})")
        log(f"srflow train step {mode} vs high on the same batch: loss "
            f"{loss!r} vs {high!r}, {rel:.3e} relative (at most "
            f"{MODE_TRAIN_TOL['vs_high_rel']:g})")
    it = iter(range(10 ** 9))
    mode_ms = time_steps({m: in_mode(m, lambda: step(batches[next(it) % 4]))
                          for m in ("high", "mixed", "default")},
                         f"srflow train {shape} mode")
    for mode in ("mixed", "default"):
        with precision(mode):
            train_stages(lambda marks: srflow_train_step(
                model, prior, marks=marks), batches[0],
                f"srflow train {shape} {mode} kernel path")
    profile_predict(in_mode("default", lambda: step(batches[0])),
                    mode_ms["default"], f"srflow train {shape} default step",
                    top=12, what="step")
    return checks, launches


# ---------------------------------------------------------------------------
# phase 13: the evaluation entry points
# ---------------------------------------------------------------------------


def counted(batches, counts):
    """``batches`` with the launch counters reset before each is handed on
    and read once it is done (when the next is asked for): one dict of
    the kernels launched a batch, appended to ``counts``."""
    import torch

    from bfsr_tpu_torch.ops import cuda

    for batch in batches:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        yield batch
        torch.cuda.synchronize()
        counts.append({k: v for k, v in cuda.LAUNCHES.items() if v})


def counting_loader(counts):
    """The port's ``DataLoader`` with ``counted`` batches."""
    from bfsr_tpu_torch.data.loader import DataLoader

    class CountingLoader(DataLoader):
        def __iter__(self):
            return counted(super().__iter__(), counts)

    return CountingLoader


def hold_launches(label, counts, want, n):
    """Each of the ``n`` images' or batches' launches must be ``want``."""
    if len(counts) != n or any(c != want for c in counts):
        raise RuntimeError(f"{label}: launches {counts}, expected {n} x "
                           f"{want}")


def write_smooth_pngs(root, n, hw, seed):
    """``n`` smooth random RGB PNGs of (h, w) ``hw`` in ``root``: a few
    low-frequency sinusoids a channel, from ``np.random.default_rng(seed)``.
    Returns their paths."""
    import os

    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:hw[0], :hw[1]].astype(np.float32) / max(hw)
    paths = []
    for i in range(n):
        img = np.full((*hw, 3), 0.5, np.float32)
        for _ in range(4):
            fy, fx = rng.uniform(-8, 8, 2)
            img += (rng.uniform(0.02, 0.1, 3)
                    * np.sin(2 * np.pi * (fy * y + fx * x)[..., None]
                             + rng.uniform(0, 2 * np.pi, 3)))
        paths.append(os.path.join(root, f"{i:04d}.png"))
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            paths[-1])
    return paths


def downscale_pngs(src, dst, s):
    """Each PNG of ``src`` downscaled by ``s`` with PIL bicubic into
    ``dst``, under its own name."""
    import os

    from PIL import Image

    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        im = Image.open(os.path.join(src, name))
        im.resize((im.width // s, im.height // s), Image.BICUBIC).save(
            os.path.join(dst, name))


def run_test_cli(argv, kernels, counts=None):
    """``cli/test.py``'s main in this process on the card, on the kernel
    or the twin path, each image's launches appended to ``counts``."""
    from functools import partial

    from bfsr_tpu_torch.cli import test as test_cli
    from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr

    with mock.patch.object(test_cli, "DataLoader", counting_loader(
            [] if counts is None else counts)), \
            mock.patch.object(test_cli, "eval_psnr", partial(eval_psnr,
                                                   kernels=kernels)):
        return test_cli.main([*argv, "--device", "cuda"])


def eval_test_cli(tmp, dev, models, launches):
    """Phase 13 (a): the ``test.py`` twin on the three shipped test
    configs, its flags, and the DIV2K-size frame."""
    import math
    import os

    import torch
    import yaml

    from bfsr_tpu_torch.models.lpips import LPIPS
    from bfsr_tpu_torch.train import checkpoints as ckpt

    paths = {}
    for tag, (m, p) in models.items():
        for kind, mod, key in (("model", m, "model"),
                               ("prior", p, "prior_model")):
            paths[f"{tag}{kind}"] = os.path.join(tmp, f"{tag}{kind}.ckpt")
            ckpt.save_checkpoint(paths[f"{tag}{kind}"], {key: {
                **mod.spec(), "sd": mod.state_dict()}})
    paths["lpips"] = os.path.join(tmp, "lpips.pth")
    torch.save(LPIPS(seed=0).state_dict(), paths["lpips"])
    cfgs = {}
    for name in ("test-benchmark-4", "test-fast-div2k-4", "test-ood-div2k-8"):
        with open(ROOT / "configs" / "test" / f"{name}.yaml") as f:
            cfg = yaml.safe_load(f)
        args = cfg["test_dataset"]["dataset"]["args"]
        if "root_path" in args:
            args["root_path"] = os.path.join(tmp, "hr")
        else:
            args["root_path_1"] = os.path.join(tmp, "lr")
            args["root_path_2"] = os.path.join(tmp, "hr")
        cfgs[name] = os.path.join(tmp, f"{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(cfg, f)

    def argv(cfg, *flags, tag="", prior=True):
        return ["--config", cfg, "--model", paths[f"{tag}model"], *flags,
                *(("--prior_model", paths[f"{tag}prior"]) if prior else ())]

    def both(label, args, want):
        counts, psnr = [], {}
        t0 = time.perf_counter()
        psnr["kernel"] = run_test_cli(args, True, counts)
        t1 = time.perf_counter()
        psnr["twin"] = run_test_cli(args, False)
        hold_launches(label, counts, want, 2)
        diff = abs(psnr["kernel"] - psnr["twin"])
        log(f"eval test.py {label}: psnr kernel path {psnr['kernel']!r}, twin "
            f"path {psnr['twin']!r} dB (|diff| {diff:.2e}, at most "
            f"{TOL['eval_psnr_db']:g}); kernel path {t1 - t0:.2f} s for 2 "
            f"images; launches an image {json.dumps(counts[0])}")
        if not (math.isfinite(psnr["kernel"]) and diff <= TOL["eval_psnr_db"]):
            raise RuntimeError(f"eval test.py {label}: kernel path "
                               f"{psnr['kernel']} vs twin path "
                               f"{psnr['twin']} dB")
        return counts[0]

    for name, cfg in cfgs.items():
        launches["eval_test"] = both(name, argv(cfg), EVAL_LAUNCHES["test"])
    div2k = cfgs["test-fast-div2k-4"]
    res = run_test_cli(argv(div2k, "--detail", "--lpips_weights",
                            paths["lpips"]), True)
    if set(res) != {"psnr", "ssim", "lpips", "LR recon"} or not all(
            math.isfinite(v) for v in res.values()):
        raise RuntimeError(f"eval test.py --detail: {res}")
    res = run_test_cli(argv(div2k, "--detail", "--no_lpips", "--randomness",
                            "--temperature", "0.8", prior=False), True)
    if not res["diversity"] > 0:
        raise RuntimeError(f"eval test.py --randomness: {res}")
    with contextlib.chdir(tmp):
        run_test_cli(argv(div2k, "--sample", "1", "--name", "smoke"), True)
    png = os.path.join(tmp, "sample", "smoke", "801x4.png")
    if not os.path.exists(png):
        raise RuntimeError(f"eval test.py --sample 1: no {png}")
    res = run_test_cli(argv(div2k, "--window", "8"), True)
    if not math.isfinite(res):
        raise RuntimeError(f"eval test.py --window 8: {res}")
    log(f"eval test.py: --detail (random LPIPS), --randomness --temperature "
        f"0.8 (no prior; diversity > 0), --sample 1 ({png}) and --window 8 "
        "ran")
    launches["eval_test_patch"] = both(
        "test-benchmark-4 --patch", argv(cfgs["test-benchmark-4"], "--patch",
                                         tag="patch_"),
        EVAL_LAUNCHES["test_patch"])
    time_eval_predict(models[""], os.path.join(tmp, "lr"),
                      os.path.join(tmp, "hr"), dev)


def hold_images(label, out, ref, tol):
    """The kernel path's image ``out`` must be finite, of ``ref``'s shape,
    and within ``tol`` of the twin path's ``ref`` everywhere."""
    import torch

    err = (float((out - ref).abs().max()) if out.shape == ref.shape
           else float("inf"))
    log(f"{label}: shape {tuple(out.shape)}, max |kernel - twin| {err:.3e} "
        f"(tol {tol:g}), max |twin| {float(ref.abs().max()):.3f}")
    if not (torch.isfinite(out).all() and err <= tol):
        raise RuntimeError(f"{label}: kernel path disagrees with the twin "
                           f"path: {err:.3e}")


def time_eval_predict(models, lr_dir, hr_dir, dev, label="eval test.py"):
    """The predict of the first LR / HR pair (the paired wrapper's) on
    both paths, the images held to ``TOL['image']``, then timed; returns
    the kernel path's predict and its median ms."""
    import numpy as np
    import torch

    from bfsr_tpu_torch.data.image_folder import PairedImageFolders
    from bfsr_tpu_torch.data.wrappers import SRImplicitPairedFast, batches
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    model, prior = models
    batch = next(batches(SRImplicitPairedFast(PairedImageFolders(lr_dir,
                                                                 hr_dir))))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    args = (t((batch["inp"] - 0.5) / 0.5), t(batch["coord"]),
            t(batch["cell"]), t(batch["gt_lr_up"]))
    paths = {k: (lambda p=LINFPredictor(model, prior, kernels=k == "kernel"):
                 p.predict(*args)) for k in ("twin", "kernel")}
    H, W = batch["gt"].shape[1:3]
    h, w = batch["inp"].shape[1:3]
    ref = paths["twin"]()
    hold_images(f"{label} {w}x{h}->{W}x{H} image", paths["kernel"](), ref,
                TOL["image"])
    del ref
    fast = H * W < 1e6
    medians = time_paths(paths, H * W / 1e6, f"{label} {w}x{h}->{W}x{H}",
                         blocks=3 if fast else 2, per_block=5 if fast else 2)
    return paths["kernel"], medians["kernel"]


def eval_div2k_frame(tmp, dev, model, prior):
    """Phase 13 (a): one DIV2K-size frame (HR 2040x1356 at x4) through
    ``eval_psnr`` on both paths with its launches counted, then its
    predicts timed and the kernel path's peak memory."""
    import os

    import torch

    from bfsr_tpu_torch.data.image_folder import PairedImageFolders
    from bfsr_tpu_torch.data.wrappers import SRImplicitPairedFast, batches
    from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr

    hr_dir, lr_dir = os.path.join(tmp, "div2k_hr"), os.path.join(tmp,
                                                                  "div2k_lr")
    write_smooth_pngs(hr_dir, 1, EVAL_DIV2K_HR, 5)
    downscale_pngs(hr_dir, lr_dir, EVAL_SCALE)
    t0 = time.perf_counter()
    batch = next(batches(SRImplicitPairedFast(PairedImageFolders(lr_dir,
                                                                 hr_dir))))
    log(f"eval div2k frame: LR {batch['inp'].shape[1:3]} -> HR "
        f"{batch['gt'].shape[1:3]}, wrapper (PNG decode, residual) "
        f"{time.perf_counter() - t0:.2f} s on the host")
    norm = {"inp": {"sub": [0.5], "div": [0.5]},
            "gt": {"sub": [0.5], "div": [0.5]}}
    psnr, counts = {}, []
    for path in ("kernel", "twin"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        psnr[path] = eval_psnr(counted([batch], counts) if path == "kernel"
                               else [batch], model, prior, data_norm=norm,
                               eval_type="div2k-4", kernels=path == "kernel")
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        log(f"eval div2k frame {path} path: psnr {psnr[path]!r} dB, peak "
            f"{peak:.1f} MiB above {base / 2 ** 20:.1f} resident")
    hold_launches("eval div2k frame", counts, EVAL_LAUNCHES["test"], 1)
    if not abs(psnr["kernel"] - psnr["twin"]) <= TOL["eval_psnr_db"]:
        raise RuntimeError(f"eval div2k frame: kernel path {psnr['kernel']} "
                           f"vs twin path {psnr['twin']} dB")
    fn, ms = time_eval_predict((model, prior), lr_dir, hr_dir, dev,
                               "eval div2k")
    profile_predict(fn, ms, "eval div2k 2040x1356", top=8)
    time_div2k_cli(tmp, lr_dir, hr_dir)


def time_div2k_cli(tmp, lr_dir, hr_dir):
    """Phase 13 (a): ``cli/test.py``'s seconds for the DIV2K-size frame on
    the kernel path (checkpoint load, PNG decode, wrapper, predict,
    metrics), its residual from the native host library and from the numpy
    twin, in the order native, twin, twin, native; the checkpoints and the
    ``test-fast-div2k-4`` config ``eval_test_cli`` wrote, the config's
    paths rewritten to the frame."""
    import os

    import yaml

    from bfsr_tpu_torch.profiling.loader_times import residual_path

    with open(os.path.join(tmp, "test-fast-div2k-4.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["test_dataset"]["dataset"]["args"].update(root_path_1=lr_dir,
                                                  root_path_2=hr_dir)
    path = os.path.join(tmp, "div2k-frame.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    argv = ["--config", path, "--model", os.path.join(tmp, "model.ckpt"),
            "--prior_model", os.path.join(tmp, "prior.ckpt")]
    secs, psnr = {"native": [], "numpy": []}, {}
    for residual in ("native", "numpy", "numpy", "native"):
        with residual_path(residual):
            t0 = time.perf_counter()
            psnr[residual] = run_test_cli(argv, True)
            secs[residual].append(time.perf_counter() - t0)
    log("time eval test.py div2k frame (1 image, kernel path): " + "; ".join(
        f"residual {k} {statistics.mean(v):.3f} s an image (runs "
        f"{[round(t, 3) for t in v]}), psnr {psnr[k]!r}"
        for k, v in secs.items()))
    if not abs(psnr["native"] - psnr["numpy"]) <= TOL["eval_psnr_db"]:
        raise RuntimeError(f"eval test.py div2k frame: native residual "
                           f"{psnr['native']} vs numpy twin {psnr['numpy']} "
                           "dB")


def eval_validation(tmp, dev, model, prior, launches):
    """Phase 13 (b): eval_psnr over VAL_BATCHES batches of VAL_BATCH val
    crops at inp_size VAL_INP (random query subsets), both paths; then one
    ``cli/train.py`` epoch with validation."""
    import math
    import os
    import random

    import numpy as np
    import torch
    import yaml

    from bfsr_tpu_torch.cli import train as train_cli
    from bfsr_tpu_torch.data.image_folder import ImageFolder
    from bfsr_tpu_torch.data.loader import stack
    from bfsr_tpu_torch.data.wrappers import SRImplicitDownsampledFast
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor, eval_psnr

    val_dir = os.path.join(tmp, "val")
    data = SRImplicitDownsampledFast(
        ImageFolder(val_dir, repeat=8, cache="in_memory"), inp_size=VAL_INP,
        scale_max=4)
    random.seed(0)
    np.random.seed(0)
    items = [data[i] for i in range(VAL_BATCH * VAL_BATCHES)]
    batches = [stack(items[i:i + VAL_BATCH])
               for i in range(0, len(items), VAL_BATCH)]
    norm = {"inp": {"sub": [0.5], "div": [0.5]},
            "gt": {"sub": [0.5], "div": [0.5]}}
    psnr, counts, secs = {}, [], {}
    for path in ("kernel", "twin", "kernel"):
        t0 = time.perf_counter()
        psnr[path] = eval_psnr(
            counted(batches, counts) if not counts and path == "kernel"
            else batches, model, prior, data_norm=norm,
            kernels=path == "kernel")
        secs[path] = (time.perf_counter() - t0) / VAL_BATCHES
    hold_launches("eval validation", counts, EVAL_LAUNCHES["val"],
                  VAL_BATCHES)
    launches["eval_val"] = counts[0]
    b = batches[0]
    args = [torch.as_tensor(a, device=dev) for a in (
        (b["inp"] - 0.5) / 0.5, b["coord"], b["cell"], b["gt_lr_up"])]
    args = [a.float() for a in args]
    hold_images(f"eval validation batch of {VAL_BATCH} image",
                *(LINFPredictor(model, prior, kernels=k).predict(*args)
                  for k in (True, False)), TOL["image"])
    diff = abs(psnr["kernel"] - psnr["twin"])
    log(f"eval validation ({VAL_BATCHES} batches of {VAL_BATCH} crops at "
        f"inp_size {VAL_INP}, each query at its own coordinate): psnr kernel "
        f"path {psnr['kernel']!r}, twin path {psnr['twin']!r} dB (|diff| "
        f"{diff:.2e}, at most {TOL['eval_psnr_db']:g}); {secs['kernel']:.4f} "
        f"s a batch on the kernel path (the second run; host included), "
        f"{secs['twin']:.4f} on the twin path; launches a batch "
        f"{json.dumps(counts[0])}")
    if not (math.isfinite(psnr["kernel"]) and diff <= TOL["eval_psnr_db"]):
        raise RuntimeError(f"eval validation: kernel path {psnr['kernel']} "
                           f"vs twin path {psnr['twin']} dB")

    with open(ROOT / "configs" / "train"
              / "train_edsr-baseline-linf-LP.yaml") as f:
        cfg = yaml.safe_load(f)
    train_args = cfg["train_dataset"]["dataset"]["args"]
    train_args.update(root_path=os.path.join(tmp, "hr"), repeat=8)
    val_args = cfg["val_dataset"]["dataset"]["args"]
    val_args.update(root_path=val_dir, repeat=VAL_BATCH // 4)
    cfg.update(epoch_max=1, epoch_val=1, epoch_save=None,
               resume=os.path.join(tmp, "no-such.pth"))
    with open(os.path.join(tmp, "train.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    with contextlib.chdir(tmp):
        train_cli.cli(["--config", "train.yaml", "--name", "smoke",
                       "--allow_random_vgg", "--device", "cuda"])
    lines = [line for line in open(os.path.join(
        tmp, "save", "smoke", "log.txt")).read().splitlines()
        if "val: psnr=" in line]
    val = (float(lines[0].split("val: psnr=")[1].split(",")[0]) if lines
           else float("nan"))
    log(f"eval cli/train.py: one epoch with epoch_val 1 in "
        f"{time.perf_counter() - t0:.2f} s: {lines}")
    if not math.isfinite(val):
        raise RuntimeError(f"eval cli/train.py: no finite val: psnr= line "
                           f"({lines})")


def eval_srflow_test_cli(tmp, dev, launches):
    """Phase 13 (c): the ``srflow_test.py`` twin on the LR / HR pairs with
    the flagship SRFlow-LP conf, on both paths."""
    import csv
    import glob
    import os

    import torch
    import yaml

    from bfsr_tpu_torch.cli import srflow_test as srflow_cli
    from bfsr_tpu_torch.entry import build_srflow_lp
    from bfsr_tpu_torch.ops import cuda

    smodel, sprior = build_srflow_lp(dev, seed=0)
    with open(ROOT / "configs" / "srflow" / "SRFlow-LP_DF2K_4X.yml") as f:
        conf = yaml.safe_load(f)
    conf.update(dataroot_LR=os.path.join(tmp, "lr"),
                dataroot_GT=os.path.join(tmp, "hr"),
                model_path=os.path.join(tmp, "srflow.pth"),
                prior_model_path=os.path.join(tmp, "srflow_prior.pth"))
    torch.save(smodel.state_dict(), conf["model_path"])
    torch.save(sprior.state_dict(), conf["prior_model_path"])
    del smodel, sprior
    with open(os.path.join(tmp, "srflow.yml"), "w") as f:
        yaml.safe_dump(conf, f)
    rows, counts = {}, []

    class Counting(srflow_cli.SRFlowLPPredictor):
        def predict(self, lr_img01):
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            out = super().predict(lr_img01)
            torch.cuda.synchronize()
            counts.append({k: v for k, v in cuda.LAUNCHES.items() if v})
            return out

    class Twin(srflow_cli.SRFlowLPPredictor):
        def __init__(self, model, prior, pad_multiple=2):
            super().__init__(model, prior, kernels=False,
                             pad_multiple=pad_multiple)

    for path, cls in (("kernel", Counting), ("twin", Twin)):
        os.makedirs(os.path.join(tmp, path), exist_ok=True)
        t0 = time.perf_counter()
        with contextlib.chdir(os.path.join(tmp, path)), \
                mock.patch.object(srflow_cli, "SRFlowLPPredictor", cls):
            rows[path] = srflow_cli.main([os.path.join(tmp, "srflow.yml"),
                                          "--no_lpips", "--device", "cuda"])
        log(f"eval srflow_test.py {path} path: {time.perf_counter() - t0:.2f}"
            " s (the flagship's load and freeze included)")
        with open(os.path.join(tmp, path, "results", "SRFlow-LP",
                               "measure_full.csv")) as f:
            table = list(csv.reader(f))
        if len(table) != 3 or any(len(r) != 6 for r in table):
            raise RuntimeError(f"eval srflow_test.py: the CSV is {table}")
    hold_launches("eval srflow_test.py", counts, EVAL_LAUNCHES["srflow_test"],
                  2)
    smodel = srflow_cli.load_srflow(conf, dev)
    sprior = srflow_cli.load_prior(conf, dev, train=False)
    lr = srflow_cli.read_rgb(sorted(glob.glob(os.path.join(
        conf["dataroot_LR"], "*.png")))[0])
    lr = torch.as_tensor(lr / 255.0, dtype=torch.float32, device=dev)
    paths = {k: (lambda p=srflow_cli.SRFlowLPPredictor(
        smodel, sprior, kernels=k == "kernel"): p.predict(lr))
        for k in ("twin", "kernel")}
    h, w = lr.shape[:2]
    check_srflow_predict(smodel, sprior, lr,
                         f"eval srflow_test.py {w}x{h}->{4 * w}x{4 * h}")
    time_paths(paths, 16 * h * w / 1e6,
               f"eval srflow_test.py {w}x{h}->{4 * w}x{4 * h}")
    del smodel, sprior
    launches["eval_srflow_test"] = counts[0]
    for k, r in zip(rows["kernel"], rows["twin"]):
        diffs = {m: abs(k[m] - r[m]) for m in ("PSNR", "SSIM", "LRC PSNR")}
        log(f"eval srflow_test.py image {k['name']}: kernel path PSNR "
            f"{k['PSNR']!r}, SSIM {k['SSIM']!r}, LRC PSNR {k['LRC PSNR']!r}; "
            f"|diff| from the twin path {diffs}")
        if not (diffs["PSNR"] <= TOL["eval_psnr_db"]
                and diffs["LRC PSNR"] <= TOL["eval_psnr_db"]
                and diffs["SSIM"] <= TOL["eval_ssim"]):
            raise RuntimeError(f"eval srflow_test.py: kernel path {k} vs "
                               f"twin path {r}")


def run_eval(dev):
    """Phase 13: the evaluation entry points.  Returns their launches an
    image (a val batch)."""
    import os
    import tempfile

    import torch

    from bfsr_tpu_torch.entry import build_flagship, build_linf_patch

    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_smooth_pngs(os.path.join(tmp, "hr"), 2, EVAL_HR, 1)
        downscale_pngs(os.path.join(tmp, "hr"), os.path.join(tmp, "lr"),
                       EVAL_SCALE)
        write_smooth_pngs(os.path.join(tmp, "val"), 4, EVAL_HR, 2)
        model, prior = build_flagship(dev, seed=0)
        eval_test_cli(tmp, dev, {"": (model, prior),
                                 "patch_": build_linf_patch(dev, seed=0)},
                      launches)
        eval_div2k_frame(tmp, dev, model, prior)
        torch.cuda.empty_cache()
        eval_validation(tmp, dev, model, prior, launches)
        del model, prior
        torch.cuda.empty_cache()
        eval_srflow_test_cli(tmp, dev, launches)
    log(f"eval: phase 13 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: SRFlow base-model training, validate, the RRDB's plain-SR trainer
# ---------------------------------------------------------------------------

# srflow_train.py without --prior on configs/srflow/SRFlow-LP_DF2K_4X.yml:
# the train section of phase 12 (batch 12 of 160^2 GT, Adam at 2.5e-4,
# betas (0.9, 0.99), its MultiStepLR), now over every parameter of the
# model, weight_fl 1 and no weight_l1 (the conf sets none); a frozen-phase
# step's launches (the RRDB's dense-block convs on K3; the trained flow
# runs unfused, on no kernel) and the live phase's (none: the RRDB trains
# on cuDNN); validate's heats and samples (the conf's val section) on one
# batch of 2 val pairs of 160^2, whose launches: the RRDB once on K3, each
# of the 4 x 3 samples' 48 conditional steps on K5's reverse (the NLL runs
# unfused); the plain-SR trainer's batch (the x4 RRDB at 64 x 23, B 16 of
# 32^2 LQ, Charbonnier)
BASE_TRAIN_LAUNCHES = {"conv3x3_cat": 345}
VAL_HEATS, VAL_SAMPLES, VAL_PAIRS = (0.0, 0.5, 0.75, 1.0), 3, 2
SR_TRAIN_BATCH, SR_TRAIN_LQ = 16, 32
# the RRDB's conditioning maps on K3 against the same RRDB on cuDNN (the
# live phase's convs), each relative to its largest value: 23 blocks of
# f32 convs summed in another order; validate's NLL on the kernel path's
# records against the twin path's, relative
BASE_TOL = {"rrdb_cudnn_rel": 1e-4, "nll_rel": 1e-5}


def base_train_step(model, freeze, kernels=True, marks=None):
    """The base trainer's step at the flagship's optimizer and schedule (a
    fresh Adam over every parameter of the model): the frozen form, or
    the live form past its unfreeze."""
    from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step

    opt, sched = srflow_adam(model.parameters())
    return make_srflow_train_step(
        model, opt, 1.0, 0.0, rrdb_unfreeze_step=None if freeze else 0,
        freeze_rrdb=freeze, kernels=kernels, scheduler=sched, marks=marks)


def quant_noise(batch, seed):
    """Quantisation noise (U - 0.5) / 32 for the batch's GT from a seeded
    generator on the card, so that two paths see the same."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand(batch["GT"].shape, generator=gen, device="cuda")
            - 0.5) / 32


def rrdb_launch_checks(model, lq, label, encode=None):
    """The RRDB conditioning of ``lq`` in the current mode (or
    ``encode(lq, conv=...)``, LINF's RRDB encoder), each of its K3
    launches (the bf16 K3 under default) against its twin on that
    launch's input, within the kernel's own tolerance (TOL).  Returns a
    line for the log."""
    import torch

    from bfsr_tpu_torch.models.unet import k3, k3_twin
    from bfsr_tpu_torch.ops import nn as fnn

    name = "conv3x3_cat_bf16" if fnn.bf16_stage() else "conv3x3_cat"
    worst = [0, 0.0, ""]

    def conv(blocks, m, act):
        y = k3(blocks, m, act)
        ok, err, tol_s = within(y, k3_twin(blocks, m, act), TOL[name])
        if not ok:
            raise RuntimeError(f"{label}: {name} launch {worst[0] + 1} on the "
                               f"step's own values disagrees with its twin: "
                               f"max abs err {err:.3e} ({tol_s})")
        worst[:] = [worst[0] + 1, max(worst[1], err), tol_s]
        return y

    with torch.no_grad():
        (encode or model.rrdb_preprocess)(lq, conv=conv)
    return (f"the RRDB launch by launch: {name} x {worst[0]} max abs err "
            f"{worst[1]:.3e} ({worst[2]})")


def _launched():
    import torch

    from bfsr_tpu_torch.ops import cuda

    torch.cuda.synchronize()
    return {k: v for k, v in cuda.LAUNCHES.items() if v}


def check_base_frozen_step(model, batch, noise,
                           label="srflow base train step frozen"):
    """A frozen-phase step's loss and gradients on the kernel path, with
    the launch counters reset first (BASE_TRAIN_LAUNCHES), its RRDB held
    launch by launch, against the twin path from the same state, batch and
    noise, held to the twin path's spread under LQ x (1 +- 1e-7)
    (``hold_step``).  Returns (launches, (the twin path's metrics, its
    gradients, the nudged gradients))."""
    from bfsr_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    mets, grads = base_train_step(model, True).loss_and_grads(batch, 0, noise)
    launches = _launched()
    if launches != BASE_TRAIN_LAUNCHES:
        raise RuntimeError(f"{label}: launches {launches}, expected "
                           f"{BASE_TRAIN_LAUNCHES}")
    held = "; " + rrdb_launch_checks(model, batch["LQ"], label)
    twin = base_train_step(model, True, kernels=False)
    ref, ref_grads = twin.loss_and_grads(batch, 0, noise)
    nudged = [twin.loss_and_grads(dict(
        batch, LQ=batch["LQ"] * (1 + sign * GRAD_NUDGE)), 0, noise)[1]
        for sign in (1, -1)]
    hold_step(label, mets, grads, ref, ref_grads, nudged,
              f"the larger of LQ x (1 +- {GRAD_NUDGE:g})", held)
    log(f"{label}: launches {launches}; "
        + ", ".join(f"{k} {float(v)!r}" for k, v in mets.items()))
    return launches, (ref, ref_grads, nudged)


def check_base_live_step(model, batch, noise, frozen_twin,
                         label="srflow base train step live"):
    """The live step at the same weights, batch and noise: no kernel
    launched; its loss and the flow's gradients against the frozen twin
    step's, within that step's spread (``hold_step``); and the RRDB's
    conditioning on K3 against the same RRDB on cuDNN."""
    import torch

    from bfsr_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    mets, grads = base_train_step(model, False).loss_and_grads(batch, 0,
                                                               noise)
    launches = _launched()
    if launches:
        raise RuntimeError(f"{label}: launches {launches}, expected none")

    def flow(g):
        return {k: v for k, v in g.items() if not k.startswith("RRDB.")}

    ref, ref_grads, nudged = frozen_twin
    n_rrdb = sum(bool(v.any()) for k, v in grads.items()
                 if k.startswith("RRDB."))
    hold_step(f"{label} (the flow's gradients, the RRDB on cuDNN) vs the "
              "frozen step's twin path", mets, flow(grads), ref,
              flow(ref_grads), [flow(n) for n in nudged],
              f"the larger of LQ x (1 +- {GRAD_NUDGE:g})")
    with torch.no_grad():
        k = model.rrdb_preprocess(batch["LQ"], kernels=True)
        c = model.rrdb_preprocess(batch["LQ"], kernels=False)
    errs = {key: float((k[key] - c[key]).abs().max() / c[key].abs().max())
            for key in model.cond_keys()}
    if not all(e <= BASE_TOL["rrdb_cudnn_rel"] for e in errs.values()):
        raise RuntimeError(f"{label}: the RRDB on K3 vs on cuDNN: {errs} "
                           f"relative (at most {BASE_TOL['rrdb_cudnn_rel']})")
    log(f"{label}: launches none; {n_rrdb} RRDB gradient tensors non-zero; "
        f"the RRDB's conditioning maps on K3 vs on cuDNN, max abs err "
        f"relative to the largest value: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (at most {BASE_TOL['rrdb_cudnn_rel']:g})")


def check_base_default_step(model, batch, noise):
    """One frozen-phase step under default: the bf16 K3 345 times, the
    RRDB held launch by launch, the loss finite."""
    import math

    from bfsr_tpu_torch.ops import cuda

    label = "srflow base train step frozen default"
    want = {"conv3x3_cat_bf16": BASE_TRAIN_LAUNCHES["conv3x3_cat"]}
    with precision("default"):
        cuda.reset_launch_counts()
        mets, _ = base_train_step(model, True).loss_and_grads(batch, 0,
                                                              noise)
        launches = _launched()
        if launches != want or not math.isfinite(float(mets["loss"])):
            raise RuntimeError(f"{label}: launches {launches} (expected "
                               f"{want}), loss {float(mets['loss'])!r}")
        held = rrdb_launch_checks(model, batch["LQ"], label)
    log(f"{label}: launches {launches}; loss {float(mets['loss'])!r}; {held}")
    return launches


def check_validate(model, dev, label="validate"):
    """``validate`` on one batch of VAL_PAIRS val pairs at VAL_HEATS x
    VAL_SAMPLES on the kernel path, the launch counters reset first (K3
    345, K5 48 reverse a sample), and on the twin path: the heat-0 images
    within TOL['srflow_image'], the NLL within BASE_TOL['nll_rel']
    relative.  Returns the launches."""
    import torch

    from bfsr_tpu_torch.entry import example_srflow_train_batch
    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.srflow_eval import validate

    n_cond = sum(e["kind"] == "step_cond" for e in model.plan)
    want = {"conv3x3_cat": BASE_TRAIN_LAUNCHES["conv3x3_cat"],
            "flow_step_reverse": n_cond * len(VAL_HEATS) * VAL_SAMPLES}
    val = [example_srflow_train_batch(dev, 50, VAL_PAIRS, SRFLOW_TRAIN_GT,
                                      model.scale)]
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nll, samples = validate(model, val, VAL_HEATS, VAL_SAMPLES)
    launches = _launched()
    kernel_s = time.perf_counter() - t0
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, expected {want}")
    t0 = time.perf_counter()
    ref_nll, ref = validate(model, val, VAL_HEATS, VAL_SAMPLES,
                            kernels=False)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    rel = abs(nll - ref_nll) / abs(ref_nll)
    errs = {k: float((samples[k] - ref[k]).abs().max()) for k in samples}
    heat0 = max(e for (h, _), e in errs.items() if h == 0.0)
    if not (rel <= BASE_TOL["nll_rel"] and heat0 <= TOL["srflow_image"]
            and all(torch.isfinite(v).all() for v in samples.values())):
        raise RuntimeError(f"{label}: nll {nll!r} vs twin path {ref_nll!r} "
                           f"({rel:.3e} relative); images max abs err "
                           f"{errs}")
    log(f"{label} {VAL_PAIRS} pairs of {SRFLOW_TRAIN_GT}^2 at heats "
        f"{VAL_HEATS} x {VAL_SAMPLES}: launches {launches}; nll {nll!r} "
        f"bits/dim vs twin path {ref_nll!r} ({rel:.3e} relative, at most "
        f"{BASE_TOL['nll_rel']:g}); heat-0 images max abs err {heat0:.3e} "
        f"(at most {TOL['srflow_image']:g}); heat > 0 (the same draws): "
        + ", ".join(f"{h:g}: {max(e for (hh, _), e in errs.items() if hh == h):.3e}"
                    for h in VAL_HEATS[1:])
        + f"; {kernel_s * 1e3:.1f} ms kernel path, {twin_s * 1e3:.1f} ms "
        "twin path (with freeze())")
    return launches


def run_sr_trainer(dev):
    """The RRDB's plain-SR trainer: the x4 RRDB at 64 x 23 (gc 32), B 16
    of 32^2 LQ, Charbonnier, Adam at 2e-4: no kernel launched, losses
    finite, ms/step and peak memory."""
    import numpy as np
    import torch

    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import synthetic_lrhr_sample
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.sr_train import make_sr_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    model = registry.make({"name": "rrdb", "args": {
        "nf": 64, "nb": 23, "gc": 32, "no_upsampling": False}})
    model.reset_parameters(seeded(0))
    model = model.to(dev).train()
    opt = make_optimizer({"name": "adam", "args": {
        "lr": 2e-4, "betas": (0.9, 0.99)}}, model.parameters())
    step = make_sr_train_step(model, opt, "cb")
    batches = []
    for seed in range(2):
        rng = np.random.default_rng(60 + seed)
        ss = [synthetic_lrhr_sample(rng, 4 * SR_TRAIN_LQ)
              for _ in range(SR_TRAIN_BATCH)]
        batches.append({k: torch.as_tensor(np.stack([s[k] for s in ss]),
                                           device=dev) for k in ss[0]})
    cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batches[i % 2])["loss"] for i in range(3)]
    launches = _launched()
    if launches or not np.isfinite(losses).all():
        raise RuntimeError(f"sr train: launches {launches} (expected none), "
                           f"losses {losses}")
    it = iter(range(10 ** 9))
    med = time_steps({"kernel": lambda: step(batches[next(it) % 2])},
                     f"sr train B={SR_TRAIN_BATCH} {SR_TRAIN_LQ}^2 LQ x4 cb",
                     per_block=3)
    peak = torch.cuda.max_memory_allocated()
    log(f"sr train: losses {losses} (Charbonnier sums over "
        f"{SR_TRAIN_BATCH} x {4 * SR_TRAIN_LQ}^2 x 3); no kernel launched; "
        f"peak memory {peak / 2**20:.1f} MiB; median {med['kernel']:.3f} "
        "ms/step")


def run_srflow_base_trainer(dev):
    """Phase 14: the SRFlow base trainer at its full configuration, its
    validation and the RRDB's plain-SR trainer.  Returns {path:
    launches}."""
    import tempfile

    import numpy as np
    import torch

    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.data.loader import DataLoader
    from bfsr_tpu_torch.data.pkl_dataset import LRHRPkl
    from bfsr_tpu_torch.entry import (example_srflow_train_batch,
                                      srflow_specs)
    from bfsr_tpu_torch.models.base import seeded

    t0 = time.perf_counter()
    model = registry.make(srflow_specs()[0])
    model.reset_parameters(seeded(0))
    model = model.to(dev).freeze()
    batches = [example_srflow_train_batch(dev, 40 + seed, SRFLOW_TRAIN_BATCH,
                                          SRFLOW_TRAIN_GT)
               for seed in range(4)]
    model.prime_actnorms(batches[0]["GT"], batches[0]["LQ"])
    n_params = sum(p.numel() for p in model.parameters())
    log(f"srflow base train: model ({n_params} parameters, "
        f"{sum(p.numel() for p in model.RRDB.parameters())} in the RRDB) "
        f"built, actnorms primed on the first of 4 synthetic batches of "
        f"{SRFLOW_TRAIN_BATCH} x {SRFLOW_TRAIN_GT}^2 GT in "
        f"{time.perf_counter() - t0:.2f} s")
    noise = quant_noise(batches[0], 0)
    launches = {}
    launches["srflow_base_train"], frozen_twin = check_base_frozen_step(
        model, batches[0], noise)
    check_base_live_step(model, batches[0], noise, frozen_twin)
    del frozen_twin
    launches["srflow_base_train_default"] = check_base_default_step(
        model, batches[1], quant_noise(batches[1], 1))

    shape = f"B={SRFLOW_TRAIN_BATCH} {SRFLOW_TRAIN_GT}^2"
    it = iter(range(10 ** 9))
    medians = {}
    for form in ("frozen", "live"):
        step = base_train_step(model, form == "frozen")
        if form == "live":
            rrdb0 = {k: v.detach().clone()
                     for k, v in model.RRDB.named_parameters()}
            step(batches[1])
            still = [k for k, v in model.RRDB.named_parameters()
                     if torch.equal(v, rrdb0[k])]
            head = [k for k in rrdb0
                    if k.split(".")[0] in ("upconv2", "HRconv", "conv_last")]
            if sorted(still) != sorted(head):
                raise RuntimeError(f"srflow base train live step: RRDB "
                                   f"tensors that did not move {still}, "
                                   f"expected only the x4 head {head}")
            log(f"srflow base train live step: every RRDB tensor moved but "
                f"the x4 head's {len(head)}, which the flow never reads")
            del rrdb0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses = []
        medians.update(time_steps(
            {form: lambda s=step: losses.append(
                s(batches[next(it) % 4])["loss"])},
            f"srflow base train {shape} resident"))
        peak = torch.cuda.max_memory_allocated()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"srflow base train {form}: losses {losses}")
        log(f"srflow base train {form} step: peak memory "
            f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above "
            f"the {base / 2**20:.1f} MiB resident); nll_loss over its "
            f"{len(losses)} timed steps (one Adam): "
            f"{[round(v, 3) for v in losses]}")
        train_stages(lambda marks, f=form: base_train_step(
            model, f == "frozen", marks=marks), batches[0],
            f"srflow base train {shape} {form}")
        profile_predict(lambda s=step: s(batches[0]), medians[form],
                        f"srflow base train {shape} {form} step", top=12,
                        what="step")
        if form == "frozen":
            with tempfile.TemporaryDirectory() as root:
                paths = write_lrhr_pickles(root, 5 * SRFLOW_TRAIN_BATCH)
                loader = DataLoader(LRHRPkl(paths["GT"], paths["LQ"],
                                            use_flip=True,
                                            gt_size=SRFLOW_TRAIN_GT),
                                    SRFLOW_TRAIN_BATCH, shuffle=True,
                                    drop_last=True, num_workers=3, seed=0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses = [step(b)["loss"] for b in loader]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            if not np.isfinite(losses).all():
                raise RuntimeError(f"srflow base train: losses {losses}")
            log(f"time srflow base train {shape} loader-fed frozen step: "
                f"{len(losses)} steps in {wall * 1e3:.3f} ms, "
                f"{wall * 1e3 / len(losses):.3f} ms/step (the DataLoader's 3 "
                f"threads reading lrhr-pkl pickles, flips on); nll_loss "
                f"{losses[0]!r} -> {losses[-1]!r}")
    launches["srflow_validate"] = check_validate(model, dev)
    del model, batches
    torch.cuda.empty_cache()
    run_sr_trainer(dev)
    log(f"srflow base train: phase 14 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: LINF-LP's other encoders and latent modules
# ---------------------------------------------------------------------------

# (A) the RRDB-encoder LINF of configs/train/train_rrdb-linf-LP.yaml: a
# predict's launches (the encoder's 345 dense-block convs and the UNet's 9
# on K3, the info once, K1 both ways) and a trainer step's (the 345 at
# B 16, the info, K1's forward and FlowInverse); under mixed the UNet's 9
# take the bf16 K3, under default all 354
RRDB_LAUNCHES = {"conv3x3_cat": 354, "linf_info": 1, "linf_flow_forward": 1,
                 "linf_flow_inverse": 1}
RRDB_MODE_LAUNCHES = {
    "mixed": {"conv3x3_cat": 345, "conv3x3_cat_bf16": 9, "linf_info": 1,
              "linf_flow_forward": 1, "linf_flow_inverse": 1},
    "default": {"conv3x3_cat_bf16": 354, "linf_info": 1,
                "linf_flow_forward": 1, "linf_flow_inverse": 1}}
# (A) under default.  The RRDB's random features are ~28x the EDSR's
# (std 12.8, max 53 at seed 0, against 0.46 and 2.0), the Fourier head's
# frequencies reach ~30, and bf16 operands move the image to ~25 dB of
# high's on the twin path itself (PERF.md): LINF-LP's 50 dB floor does
# not apply to these weights.  Held instead: each of the encoder's 345
# launches against its twin on its own input (TOL), the kernel path at
# least twin_margin_db closer to the twin path than the twin path is to
# high (the kernel's share below the rounding's own effect), and both
# paths as close to high as each other, within high_gap_db
RRDB_DEFAULT = {"twin_margin_db": 10.0, "high_gap_db": 1.0}
RRDB_TRAIN_LAUNCHES = {"conv3x3_cat": 345, "linf_info": 1,
                       "linf_flow_forward": 1, "linf_flow_inverse": 1}
# (B) the flagship LINF with the swin_latent prior: the EDSR encoder's 34
# on K3; the latent module runs no kernel (its convs have Cout 96, its
# products are plain)
SWIN_LAUNCHES = {"conv3x3_cat": 34, "linf_info": 1, "linf_flow_forward": 1,
                 "linf_flow_inverse": 1}
# the other predicts: SwinIR and RDN encoders (no kernel) under the UNet
# prior's 9, and edsr-baseline-latent (its 10 dense and 32 body convs) as
# the flagship's prior beside the encoder's 34
OTHER_LAUNCHES = {
    "swinir_linf": {"conv3x3_cat": 9, "linf_info": 1,
                    "linf_flow_forward": 1, "linf_flow_inverse": 1},
    "rdn_linf": {"conv3x3_cat": 9, "linf_info": 1, "linf_flow_forward": 1,
                 "linf_flow_inverse": 1},
    "edsr_latent": {"conv3x3_cat": 76, "linf_info": 1,
                    "linf_flow_forward": 1, "linf_flow_inverse": 1}}
# the loader-fed epoch of train_rrdb-linf-LP.yaml: 4 DIV2K-size and 4
# Flickr2K-size PNGs, repeat 8 as shipped, batch 16: 4 steps
DF2K_HR = ((1356, 2040), (1152, 2040))
DF2K_N = 4


def launched_by(fn):
    """(fn(), the kernels it launched), the counters reset first."""
    import torch

    from bfsr_tpu_torch.ops import cuda

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    out = fn()
    return out, _launched()


def hold_predict(label, model, prior, inputs, want, tol=TOL["image"]):
    """A predict with the launch counters reset first: its launches must
    be ``want`` and its image within ``tol`` of the twin path's.  Returns
    the launches."""
    import torch

    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    torch.cuda.reset_peak_memory_stats()
    out, launches = launched_by(
        lambda: LINFPredictor(model, prior).predict(*inputs))
    peak = torch.cuda.max_memory_allocated()
    ref = LINFPredictor(model, prior, kernels=False).predict(*inputs)
    err = float((out - ref).abs().max())
    log(f"predict {label}: shape {tuple(out.shape)}, launches "
        f"{json.dumps(launches)}, max |kernel - twin| {err:.3e} (tol "
        f"{tol:g}), peak memory {peak / 2**20:.1f} MiB")
    if launches != want:
        raise RuntimeError(f"predict {label}: launches {launches}, expected "
                           f"{want}")
    if not (torch.isfinite(out).all() and err <= tol):
        raise RuntimeError(f"predict {label}: kernel path vs twin path "
                           f"{err:.3e}")
    return launches


def time_predict(label, model, prior, inputs, profile=False):
    """ms/image of the kernel and twin paths (``time_paths``), and with
    ``profile`` a kernel-path predict's profile."""
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    paths = {k: (lambda p=LINFPredictor(model, prior, kernels=k == "kernel"):
                 p.predict(*inputs)) for k in ("twin", "kernel")}
    mp = inputs[1].shape[1] * inputs[1].shape[2] / 1e6
    med = time_paths(paths, mp, label)
    if profile:
        profile_predict(paths["kernel"], med["kernel"], label, top=12)
    return med


def time_plain_convs(label, cases):
    """cuDNN's time (f32, TF32 off) and the bound of each conv that no K3
    takes, at the shape its path gives it.  cases: (name, x (NHWC), conv
    module, launches per predict)."""
    import torch
    import torch.nn.functional as F

    out = []
    with torch.inference_mode():
        for name, x, conv, n in cases:
            xc = x.permute(0, 3, 1, 2).contiguous()
            w, b = conv.weight, conv.bias
            B, H, W = x.shape[:3]
            kh, kw = w.shape[2:]
            flops = 2 * kh * kw * w.shape[1] * w.shape[0] * B * H * W
            ms = gpu_time_ms(lambda: F.conv2d(xc, w, b, padding=kh // 2))
            r = {"conv": name, "ms": ms, "launches": n,
                 **bound(flops, nbytes(x, w, b) + 4 * w.shape[0] * B * H * W)}
            log(f"plain conv {label} {name}: cuDNN {ms:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{flops / ms / 1e9:.1f} TFLOP/s, {n} a predict")
            out.append(r)
    return out


def rrdb_mode_predicts(model, prior, inputs, label):
    """(A) under mixed and default: the launches, and the image against
    the twin path in the same mode and against high's (under mixed the
    LINF-LP floors; under default RRDB_DEFAULT, with each encoder launch
    held against its twin)."""
    import torch

    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    high = LINFPredictor(model, prior).predict(*inputs)
    launches = {}
    for mode in ("mixed", "default"):
        with precision(mode):
            out, got = launched_by(
                lambda: LINFPredictor(model, prior).predict(*inputs))
            ref = LINFPredictor(model, prior, kernels=False).predict(*inputs)
            held = ("; " + rrdb_launch_checks(
                model.encoder, inputs[0], f"{label} {mode}",
                encode=model.encoder.encode) if mode == "default" else "")
        err = float((out - ref).abs().max())
        db, twin_db = agreement_db(out, high), agreement_db(out, ref)
        ref_db = agreement_db(ref, high)
        log(f"predict {label} {mode}: launches {json.dumps(got)}, max "
            f"|kernel - twin| {err:.3e}, {twin_db:.3f} dB against the twin "
            f"path; agreement vs high {db:.3f} dB, the twin path's "
            f"{ref_db:.3f}{held}")
        if got != RRDB_MODE_LAUNCHES[mode]:
            raise RuntimeError(f"predict {label} {mode}: launches {got}, "
                               f"expected {RRDB_MODE_LAUNCHES[mode]}")
        if mode == "mixed":
            ok = (db >= AGREEMENT_FLOOR_DB[mode]
                  and err <= TOL["mode_image"][mode])
        else:
            ok = (twin_db >= ref_db + RRDB_DEFAULT["twin_margin_db"]
                  and abs(db - ref_db) <= RRDB_DEFAULT["high_gap_db"])
        if not (torch.isfinite(out).all() and ok):
            raise RuntimeError(f"predict {label} {mode}: twin error "
                               f"{err:.3e} ({twin_db:.3f} dB), agreement "
                               f"{db:.3f} dB (twin path {ref_db:.3f})")
        launches[f"rrdb_linf_{mode}"] = got
    return launches


def rrdb_step_check(linf, prior, vgg, batch, label):
    """(A)'s trainer step in high.  The launches and the whole step's loss
    (TRAIN_TOL) on both paths; then the frozen part launch by launch on
    the kernel path's own values (each of the 345 K3 launches, K2, the
    flow forward within TOL), and the trainable part on both paths from
    those values, held to the twin path's spread under z_lr x (1 +
    GRAD_NUDGE).  The whole step's gradients are logged beside the twin
    path's own spread under inp x (1 + GRAD_NUDGE), not held: the random
    RRDB's features (~28x the EDSR's) feed Fourier frequencies up to ~30,
    so the ~1e-6 relative that K3 and cuDNN differ by in the features
    moves the prior's gradients by a few % (PERF.md).  Returns the
    launches."""
    import torch

    from bfsr_tpu_torch.pipelines.linf_train import make_train_step, to_device
    from bfsr_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    batch = to_device(batch, "cuda")
    step = make_train_step(linf, prior, vgg, opt)
    twin = make_train_step(linf, prior, vgg, opt, kernels=False)
    (mets, grads, _), launches = launched_by(
        lambda: step.loss_and_grads(batch))
    if launches != RRDB_TRAIN_LAUNCHES:
        raise RuntimeError(f"{label}: launches {launches}, expected "
                           f"{RRDB_TRAIN_LAUNCHES}")
    whole, whole_grads, _ = twin.loss_and_grads(batch)
    rel = abs(float(mets["loss"]) - float(whole["loss"])) / abs(
        float(whole["loss"]))
    inp_nudged = twin.loss_and_grads(dict(
        batch, inp=batch["inp"] * (1 + GRAD_NUDGE)))[1]
    log(f"{label}: the whole step, kernel path vs twin path: loss "
        f"{float(mets['loss'])!r} vs {float(whole['loss'])!r} ({rel:.3e} "
        f"relative, at most {TRAIN_TOL['loss_rel']:g}), all gradients "
        f"{global_rel_l2(grads, whole_grads):.3e} relative L2; the twin "
        f"path's own spread under inp x {1 + GRAD_NUDGE:.9g}: "
        f"{global_rel_l2(inp_nudged, whole_grads):.3e} (not held)")
    if not rel <= TRAIN_TOL["loss_rel"]:
        raise RuntimeError(f"{label}: the whole step's loss {rel:.3e} "
                           "relative from the twin path's")
    fz = step.frozen(batch)
    held = "; " + frozen_launch_checks(linf, batch, fz, label)
    kmets, kgrads, _ = step.loss_and_grads(batch, frozen=fz)
    ref, ref_grads, _ = twin.loss_and_grads(batch, frozen=fz)
    nudged = twin.loss_and_grads(batch, frozen=dict(
        fz, z_lr=fz["z_lr"] * (1 + GRAD_NUDGE)))[1]
    hold_step(f"{label} (the trainable part from the kernel path's frozen "
              "values)", kmets, kgrads, ref, ref_grads, [nudged],
              f"z_lr x {1 + GRAD_NUDGE:.9g}", held)
    return launches


def swin_step_check(linf, prior, vgg, batch, label):
    """One step of the Swin prior's trainer with stochastic depth: the
    kernel path and the twin path from the same generator state (the same
    keep masks), the loss finite and within TRAIN_TOL, the gradients
    within the twin path's own spread, the larger under ``gt_lr_up`` x (1
    +- GRAD_NUDGE) (each drawn from that state too), as phase 12 holds its
    step.  Returns (launches, the generator)."""
    import torch

    from bfsr_tpu_torch.pipelines.linf_train import make_train_step, to_device
    from bfsr_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = to_device(batch, "cuda")
    steps = {k: make_train_step(linf, prior, vgg, opt, kernels=k,
                                generator=gen) for k in (True, False)}
    state = gen.get_state()
    (mets, grads, _), launches = launched_by(
        lambda: steps[True].loss_and_grads(batch))
    gen.set_state(state)
    ref, ref_grads, _ = steps[False].loss_and_grads(batch)
    nudged = []
    for sign in (1, -1):
        gen.set_state(state)
        nudged.append(steps[False].loss_and_grads(dict(
            batch, gt_lr_up=batch["gt_lr_up"] * (1 + sign * GRAD_NUDGE)))[1])
    if launches != {k: v for k, v in TRAIN_LAUNCHES.items()}:
        raise RuntimeError(f"{label}: launches {launches}, expected "
                           f"{TRAIN_LAUNCHES}")
    hold_step(label, mets, grads, ref, ref_grads, nudged,
              f"the larger of gt_lr_up x (1 +- {GRAD_NUDGE:g}), the same "
              "keep masks")
    # a second draw gives other masks: the loss moves
    again = steps[True].loss_and_grads(batch)[0]["loss"]
    log(f"{label}: launches {launches}; loss {float(mets['loss'])!r}, with "
        f"the generator's next draws {float(again)!r}")
    if not torch.isfinite(mets["loss"]):
        raise RuntimeError(f"{label}: loss {float(mets['loss'])}")
    return launches, gen


def train_time_and_memory(linf, prior, vgg, batches, tag, generator=None):
    """ms/step of both paths on resident batches (``time_steps``), one
    kernel-path step's peak memory and its profile."""
    import torch

    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    steps = {k: make_train_step(linf, prior, vgg, opt, kernels=k == "kernel",
                                generator=generator)
             for k in ("twin", "kernel")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = steps["kernel"](batches[0])["loss"]
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: a kernel-path step's loss {loss!r}, peak memory "
        f"{peak / 2**20:.1f} MiB")
    it = iter(range(10 ** 9))
    med = time_steps({k: (lambda s=s: s(batches[next(it) % len(batches)]))
                      for k, s in steps.items()},
                     f"{tag} B={TRAIN_BATCH} {TRAIN_INP}^2 resident",
                     blocks=2, per_block=3)
    profile_predict(lambda: steps["kernel"](batches[0]), med["kernel"],
                    f"{tag} B={TRAIN_BATCH} step", top=12, what="step")
    return med


def rrdb_cli_epoch(tmp):
    """One loader-fed ``cli/train.py`` epoch of ``train_rrdb-linf-LP.yaml``
    as shipped, its folders pointed at DF2K-size PNGs written here: every
    step's launches (K3 345, K2 1, K1 1 + 1) and the epoch's seconds."""
    import math
    import os

    import yaml

    from bfsr_tpu_torch.cli import train as train_cli
    from bfsr_tpu_torch.pipelines import linf_train

    d2k, f2k = os.path.join(tmp, "DIV2K_train_HR"), os.path.join(
        tmp, "Flickr2K_HR")
    write_smooth_pngs(d2k, DF2K_N, DF2K_HR[0], 5)
    write_smooth_pngs(f2k, DF2K_N, DF2K_HR[1], 6)
    with open(ROOT / "configs" / "train" / "train_rrdb-linf-LP.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["train_dataset"]["dataset"]["args"].update(root_path_D2K=d2k,
                                                   root_path_F2K=f2k)
    cfg["val_dataset"]["dataset"]["args"]["root_path"] = d2k
    cfg.update(epoch_max=1, resume=os.path.join(tmp, "no-such.pth"))
    with open(os.path.join(tmp, "rrdb.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    counts = []
    make = linf_train.make_train_step

    def counting_step(*a, **k):
        step = make(*a, **k)

        def run(batch):
            out, got = launched_by(lambda: step(batch))
            counts.append(got)
            return out
        return run

    t0 = time.perf_counter()
    with contextlib.chdir(tmp), mock.patch.object(
            train_cli, "make_train_step", counting_step):
        train_cli.cli(["--config", "rrdb.yaml", "--name", "rrdb",
                       "--allow_random_vgg", "--device", "cuda"])
    secs = time.perf_counter() - t0
    lines = [line for line in open(os.path.join(
        tmp, "save", "rrdb", "log.txt")).read().splitlines()
        if line.startswith("epoch 1/1")]
    n = 2 * DF2K_N * cfg["train_dataset"]["dataset"]["args"]["repeat"] \
        // cfg["train_dataset"]["batch_size"]
    log(f"rrdb cli/train.py: one loader-fed epoch of train_rrdb-linf-LP.yaml "
        f"({2 * DF2K_N} DF2K-size PNGs, repeat 8, B 16: {len(counts)} steps) "
        f"in {secs:.2f} s, the models' build included: {lines}")
    hold_launches("rrdb cli/train.py", counts, RRDB_TRAIN_LAUNCHES, n)
    loss = float(lines[0].split("vgg_l=")[1].split(",")[0]) if lines else 0
    if not math.isfinite(loss) or not lines:
        raise RuntimeError(f"rrdb cli/train.py: {lines}")
    return counts[0]


def other_predicts(dev, inputs, launches, plain, checks):
    """SwinIR- and RDN-encoder LINFs (the registry's full widths, the
    flagship's flow, MLP and UNet) and the flagship with
    ``edsr-baseline-latent`` (16 blocks, dim 64) as its prior: each
    predict's launches, held against the twin path, timed."""
    import torch

    from bfsr_tpu_torch.entry import build_linf, flagship_specs

    linf_spec, unet_spec = flagship_specs()
    cases = {
        "swinir_linf": ({"name": "swinir", "args": {"no_upsampling": True}},
                        unet_spec),
        "rdn_linf": ({"name": "rdn", "args": {"no_upsampling": True}},
                     unet_spec),
        "edsr_latent": (None, {"name": "edsr-baseline-latent",
                               "args": {"in_chans": 3}})}
    for name, (enc, pspec) in cases.items():
        spec = {**linf_spec, "args": dict(linf_spec["args"])}
        if enc:
            spec["args"]["encoder_spec"] = enc
        model, prior = build_linf(spec, pspec, dev, 0)
        label = f"{name} 128x128->512x512"
        launches[name] = hold_predict(label, model, prior, inputs,
                                      OTHER_LAUNCHES[name])
        time_predict(label, model, prior, inputs)
        if name == "edsr_latent":
            rdb = prior.body[0].body[0]
            x = torch.randn((1, *HR, 64), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(7))
            checks.setdefault("conv3x3_cat", []).append(check_k3(
                "edsr-baseline-latent body conv1 64->64 @512^2", [x], rdb,
                None, rdb.bias, "lrelu"))
        del model, prior
        torch.cuda.empty_cache()
    # the full EDSR's 256-wide trunk conv at the LR extent: no K3 takes it
    from bfsr_tpu_torch import registry

    edsr = registry.make({"name": "edsr", "args": {"n_resblocks": 1,
                                                   "no_upsampling": True}})
    conv = edsr.to(dev).body[0].body[0]
    x = torch.randn((1, *LR, 256), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(8))
    plain.extend(time_plain_convs("edsr (full)", [
        ("edsr 256->256 @128^2 (x 65 a predict)", x, conv, 65)]))


def run_other_encoders(dev):
    """Phase 15: LINF-LP's other encoders and latent modules at full
    width.  Returns (K3 checks, launches by path, the plain convs' times)."""
    import tempfile

    import torch

    from bfsr_tpu_torch.entry import (build_rrdb_linf, build_swin_prior,
                                      example_inputs, example_train_batch,
                                      he_normal_vgg)

    t0 = time.perf_counter()
    checks, launches, plain = {}, {}, []
    inputs = example_inputs(dev, LR, HR, seed=0)

    # (A) the RRDB encoder: its K3 launches one by one, then the predict
    linf, prior = build_rrdb_linf(dev, seed=0)
    log("rrdb linf: " + rrdb_launch_checks(
        linf.encoder, inputs[0], "rrdb linf encoder 128^2",
        encode=linf.encoder.encode))
    batches = [example_train_batch(dev, seed, TRAIN_BATCH, TRAIN_INP,
                                   TRAIN_SCALE_MAX) for seed in range(2)]
    for case in (rrdb_k3_cases(linf.encoder, inputs[0])
                 + rrdb_k3_cases(linf.encoder, batches[0]["inp"])):
        checks.setdefault("conv3x3_cat", []).append(check_k3(*case))
    launches["rrdb_linf"] = hold_predict("rrdb linf 128x128->512x512", linf,
                                         prior, inputs, RRDB_LAUNCHES)
    time_predict("rrdb linf 128x128->512x512", linf, prior, inputs, True)
    launches.update(rrdb_mode_predicts(linf, prior, inputs,
                                       "rrdb linf 128x128->512x512"))
    # (A)'s trainer: the frozen RRDB-LINF, its UNet in train mode
    tprior, vgg = prior.train(), he_normal_vgg(dev, seed=0)
    log("rrdb train: " + rrdb_launch_checks(
        linf.encoder, (batches[0]["inp"] - 0.5) / 0.5,
        f"rrdb train encoder B={TRAIN_BATCH} {TRAIN_INP}^2",
        encode=linf.encoder.encode))
    launches["rrdb_linf_train"] = rrdb_step_check(
        linf, tprior, vgg, batches[0], "rrdb train step")
    train_time_and_memory(linf, tprior, vgg, batches, "rrdb train")
    del linf, tprior
    torch.cuda.empty_cache()

    # (B) the Swin latent module as the flagship's prior
    model, sprior = build_swin_prior(dev, seed=0)
    launches["swin_prior"] = hold_predict("swin prior 128x128->512x512",
                                          model, sprior, inputs,
                                          SWIN_LAUNCHES)
    time_predict("swin prior 128x128->512x512", model, sprior, inputs, True)
    with torch.inference_mode():
        z = torch.randn((1, *HR, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        dense = sprior.input_proj
        feats = [z]
        cases = []
        for i, c in enumerate(dense.convs()):
            x = torch.cat(feats, -1)
            cases.append((f"swin_latent input_proj conv{i + 1} "
                          f"{x.shape[-1]}->96 @512^2", x, c, 1))
            feats.append(torch.randn((1, *HR, 96), device="cuda"))
    plain.extend(time_plain_convs("swin prior", cases))
    del feats, cases, z
    torch.cuda.empty_cache()
    strain = sprior.train()
    launches["swin_prior_train"], gen = swin_step_check(
        model, strain, vgg, batches[0], "swin train step drop_path 0.1")
    train_time_and_memory(model, strain, vgg, batches, "swin train",
                          generator=gen)
    del model, sprior, strain, vgg, batches
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        launches["rrdb_linf_cli_epoch"] = rrdb_cli_epoch(tmp)
    torch.cuda.empty_cache()
    other_predicts(dev, inputs, launches, plain, checks)
    log(f"other encoders: phase 15 in {time.perf_counter() - t0:.1f} s")
    return checks, launches, plain


# ---------------------------------------------------------------------------
# phase 16: SRFlow at 8x (scale 8, L 4)
# ---------------------------------------------------------------------------

# the sampler at LR 64^2 -> HR 512^2 and at a ragged even LR, at heat 0 and
# a nonzero heat drawn from a seeded generator; a sample's launches: the
# RRDB's 345 dense-block convs on K3 and the decode's 64 conditional steps
# (16 at each of the four levels, C = 12, 24, 48, 192) on K5's reverse, the
# bf16 K3 and the served one-pass K5 under default.  The trainer: B 12 of
# 160^2 GT over 20^2 LQ, the flagship's batch at 8x.
X8_LR, X8_RAGGED_LR, X8_HEATS, X8_SEED = (64, 64), (50, 42), (0.0, 0.8), 7
X8_SAMPLE_LAUNCHES = {
    "high": {"conv3x3_cat": 345, "flow_step_reverse": 64},
    "default": {"conv3x3_cat_bf16": 345, "flow_step_bf16_reverse": 64}}


def check_k5_levels(model, lq, tag):
    """K5 f32 and both one-pass forms, forward and reverse, against their
    twins at each level of the flow for ``lq`` (B, h, w, 3): the first
    conditional step of each level on its record (f32 and ``xla`` on the
    step's own buffers, ``pallas`` on one packed here), a random state of
    the batch; the bound by ``k5_cost`` over the batch, each product at the
    peak of what runs it (bf16 values at the bf16 rate).  Returns
    {kernel: [results, each with its width and shape]}."""
    import torch

    from bfsr_tpu_torch.ops.cuda import flow_step as k5

    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for e, step, rec in first_steps(model, lq):
        c, hid = e["c"], step.hidden
        b, h, w = rec.shape[:3]
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        where = f" {tag} level {e['level']} ({b}, {h}, {w}, {c})"
        forms = [(None, step.kpacked, "high")]
        for form in k5.STEP_FORMS:
            pb = (step.kpacked_bf16 if form == step.step_form else
                  k5.pack_step_bf16(step.actnorm, step.invconv, step.affine,
                                    form))
            forms.append((form, pb, "default"))
        for form, buf, mode in forms:
            cost = k5.k5_cost(c, hid, (b * h, w), buf, form or "f32")
            with precision(mode), torch.inference_mode():
                if form is None:
                    fwd = ("flow_step_forward", k5.flow_step_forward_plain)
                    rev = ("flow_step_reverse", k5.flow_step_reverse_plain)
                else:
                    fwd, rev = k5.BF16_FORMS[form, False], \
                        k5.BF16_FORMS[form, True]
                y = fwd[1](x, rec, buf, hid)
                for (name, plain), fn, inp in (
                        (fwd, k5.flow_step_forward, x),
                        (rev, k5.flow_step_reverse, y)):
                    r = compare(
                        name, lambda: fn(inp, rec, step.kpacked, hid, buf,
                                         form or "xla"),
                        lambda: plain(inp, rec, buf, hid), TOL[name],
                        label=f" {form or 'f32'}{where}", cost=cost)
                    results.setdefault(name, []).append(
                        dict(r, width=c, shape=[b, h, w]))
    return results


def x8_decode(model, lr, heat, kernels):
    """The sampler's work after its ``freeze()``, on a padded LR batch at
    ``heat``: ``get_sr`` (unclipped) from a generator seeded with X8_SEED,
    as ``sample_sr`` draws, with no graph."""
    import torch

    from bfsr_tpu_torch.ops.cuda import TWINS

    gen = torch.Generator(device="cuda").manual_seed(X8_SEED)
    z = model.sample_z(heat, lr.shape[1:3], 1, gen, lr.device)
    with torch.no_grad():
        return model.get_sr(lr, heat, z=z, generator=gen,
                            kernels=True if kernels else TWINS)


def check_x8_sample(model, img, label, mode, tag="x8"):
    """``sample_sr`` of one LR image at each of X8_HEATS in ``mode``, the
    launch counters reset first (X8_SAMPLE_LAUNCHES), against the twin path
    on the same draws (``x8_decode`` on the twins, clipped and cropped as
    ``sample_sr`` does; ``tag`` names the model, at its scale): under high
    the clipped image within
    TOL['srflow_image'] and the unclipped one within
    TOL['srflow_unclipped_rel'] of the largest value; under default the
    image within TOL['srflow_default_twin_db'] of the twin path.  Returns
    the launches and {heat: the image}."""
    import torch

    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.srflow_eval import (lr_multiple,
                                                      pad_to_multiple,
                                                      sample_sr)
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    h, w = img.shape[:2]
    sc = model.scale
    want = X8_SAMPLE_LAUNCHES[mode]
    x = pad_to_multiple(img, lr_multiple(model))
    images = {}
    with precision(mode):
        for heat in X8_HEATS:
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            out = sample_sr(model, img, heat, X8_SEED)
            launches = _launched()
            sr, sr_ref = (x8_decode(model, x, heat, k) for k in (True, False))
            ref = torch.clamp(sr_ref[0], 0.0, 1.0)[: sc * h, : sc * w]
            torch.cuda.synchronize()
            if (launches != want or out.shape != (sc * h, sc * w, 3)
                    or not torch.isfinite(out).all()
                    or not torch.isfinite(sr).all()):
                raise RuntimeError(f"{tag} sample {label} {mode} heat {heat:g}: "
                                   f"launches {launches} (expected {want}), "
                                   f"shape {tuple(out.shape)}")
            err = float((out - ref).abs().max())
            rel = float((sr - sr_ref).abs().max() / sr_ref.abs().max())
            db = agreement_db(out, ref)
            if mode == "high":
                ok = (err <= TOL["srflow_image"]
                      and rel <= TOL["srflow_unclipped_rel"])
                held = (f"max |kernel - twin| {err:.3e} (tol "
                        f"{TOL['srflow_image']:g}); unclipped max |kernel - "
                        f"twin| / max |twin| {rel:.3e} (tol "
                        f"{TOL['srflow_unclipped_rel']:g})")
            else:
                ok = db >= TOL["srflow_default_twin_db"]
                held = (f"kernel path vs twin path {db:.3f} dB (floor "
                        f"{TOL['srflow_default_twin_db']:g}), max abs "
                        f"{err:.3e}; unclipped {rel:.3e} relative "
                        "(reported)")
            log(f"{tag} sample {label} {mode} heat {heat:g}: shape "
                f"{tuple(out.shape)}, finite, launches {json.dumps(launches)};"
                f" {held}; {100 * float(((sr_ref > 0) & (sr_ref < 1)).float().mean()):.1f}% "
                f"of the unclipped twin image inside (0, 1), max |twin| "
                f"{float(sr_ref.abs().max()):.3f}")
            if not ok:
                raise RuntimeError(f"{tag} sample {label} {mode} heat {heat:g}: "
                                   f"the kernel path disagrees with the twin "
                                   f"path: {held}")
            images[heat] = out
    return launches, images


def x8_stages(model, x, label, reps=3):
    """Device time of the sampler's stages on a padded LR (CUDA events
    between them, median of ``reps``): the RRDB, the conditioning records,
    the decode."""
    import torch

    per = {"rrdb": [], "precompute_ft": [], "decode": []}
    for _ in range(reps):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.no_grad():
            evs[0].record()
            enc = model.rrdb_preprocess(x)
            evs[1].record()
            cache = model.precompute_ft(enc)
            evs[2].record()
            model.reverse_flow([model.sample_z(0.0, x.shape[1:3], 1,
                                               device=x.device)], cache)
            evs[3].record()
        torch.cuda.synchronize()
        for k, a, b in zip(per, evs, evs[1:]):
            per[k].append(a.elapsed_time(b))
    total = sum(statistics.median(v) for v in per.values())
    log(f"stages {label}: " + ", ".join(
        f"{k} {statistics.median(v):.3f} ms "
        f"({100 * statistics.median(v) / total:.1f}%)" for k, v in per.items())
        + f"; total {total:.3f} ms")


def run_srflow_x8(dev):
    """Phase 16: SRFlow's 8x model (``bfsr_tpu_torch/configs/
    srflow_df2k_8x.yml``: RRDB 64 x 23, K 16, L 4, hidden 64) at full
    width, random live weights from seed 0.  Returns (K5's checks at its
    four widths, {path: launches})."""
    import numpy as np
    import torch

    from bfsr_tpu_torch.entry import (build_srflow_x8,
                                      example_srflow_train_batch)
    from bfsr_tpu_torch.pipelines.srflow_eval import (lr_multiple,
                                                      pad_to_multiple,
                                                      sample_sr)
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    t0 = time.perf_counter()
    model = build_srflow_x8(dev, seed=0)
    widths = [e["c"] for e in model.plan if e["kind"] == "step_cond"]
    log(f"x8: model built from seed 0 in {time.perf_counter() - t0:.2f} s; "
        f"{len(widths)} conditional steps at C = "
        f"{sorted(set(widths))}, final latent {model.final_c} channels")
    rng = np.random.default_rng(8)
    img = torch.as_tensor(rng.random((*X8_LR, 3)), dtype=torch.float32,
                          device=dev)
    ragged = torch.as_tensor(rng.random((*X8_RAGGED_LR, 3)),
                             dtype=torch.float32, device=dev)
    batches = [example_srflow_train_batch(dev, 70 + seed, SRFLOW_TRAIN_BATCH,
                                          SRFLOW_TRAIN_GT, 8)
               for seed in range(2)]
    checks = check_k5_levels(model, img[None], "x8 sample")
    for name, rs in check_k5_levels(model, batches[0]["LQ"],
                                    "x8 step").items():
        checks[name].extend(rs)

    # the sampler, both modes
    tag = f"{X8_LR[0]}x{X8_LR[1]}->{8 * X8_LR[0]}x{8 * X8_LR[1]}"
    rtag = (f"{X8_RAGGED_LR[0]}x{X8_RAGGED_LR[1]}->{8 * X8_RAGGED_LR[0]}x"
            f"{8 * X8_RAGGED_LR[1]}")
    launches = {}
    launches["srflow_x8_sample"], high = check_x8_sample(model, img, tag,
                                                         "high")
    check_x8_sample(model, ragged, rtag, "high")
    launches["srflow_x8_sample_default"], default = check_x8_sample(
        model, img, tag, "default")
    check_x8_sample(model, ragged, rtag, "default")
    for heat in X8_HEATS:
        log(f"agreement x8 sample {tag} default vs high at heat {heat:g}: "
            f"{agreement_db(default[heat], high[heat]):.3f} dB (reported)")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sample_sr(model, img, 0.0)
    torch.cuda.synchronize()
    log(f"x8 sample {tag}: sample_sr with its freeze() "
        f"{(time.perf_counter() - t1) * 1e3:.3f} ms (the times below are "
        "its decode after the freeze)")
    medians = {}
    for t, im in ((tag, img), (rtag, ragged)):
        x = pad_to_multiple(im, lr_multiple(model))
        mp = 64 * im.shape[0] * im.shape[1] / 1e6
        paths = {k: (lambda a=x, kk=k == "kernel": x8_decode(
            model, a, X8_HEATS[1], kk)) for k in ("twin", "kernel")}
        medians[t] = time_paths(paths, mp, f"x8 sample {t} heat "
                                f"{X8_HEATS[1]:g}")
    x = pad_to_multiple(img, lr_multiple(model))
    medians["modes"] = time_paths(
        {m: in_mode(m, lambda: x8_decode(model, x, X8_HEATS[1], True))
         for m in ("high", "default")}, 64 * X8_LR[0] * X8_LR[1] / 1e6,
        f"x8 sample {tag} mode")
    for mode in ("high", "default"):
        with precision(mode):
            x8_stages(model, x, f"x8 sample {tag} {mode}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            x8_decode(model, x, X8_HEATS[1], True)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        log(f"x8 sample {tag} {mode}: peak memory {peak / 2**20:.1f} MiB "
            f"({(peak - base) / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB resident)")
        profile_predict(in_mode(mode, lambda: x8_decode(
            model, x, X8_HEATS[1], True)), medians["modes"][mode],
            f"x8 sample {tag} {mode}", top=12, what="sample")

    # the base trainer at 8x, and validate
    model.prime_actnorms(batches[0]["GT"], batches[0]["LQ"])
    noise = quant_noise(batches[0], 0)
    launches["srflow_x8_train"], frozen_twin = check_base_frozen_step(
        model, batches[0], noise, "x8 base train step frozen")
    check_base_live_step(model, batches[0], noise, frozen_twin,
                         "x8 base train step live")
    del frozen_twin
    # validate on the primed weights, before the timed steps move them, as
    # phase 17 does (profiling/validate_order_probe.py, PERF.md)
    launches["srflow_x8_validate"] = check_validate(model, dev, "x8 validate")
    shape = f"x8 B={SRFLOW_TRAIN_BATCH} {SRFLOW_TRAIN_GT}^2"
    it = iter(range(10 ** 9))
    for form in ("frozen", "live"):
        step = base_train_step(model, form == "frozen")
        torch.cuda.reset_peak_memory_stats()
        losses = []
        time_steps({form: lambda s=step: losses.append(
            s(batches[next(it) % 2])["loss"])}, f"{shape} train",
            per_block=2)
        peak = torch.cuda.max_memory_allocated()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{shape} {form}: losses {losses}")
        log(f"{shape} {form} step: peak memory {peak / 2**20:.1f} MiB; "
            f"nll_loss over its {len(losses)} timed steps: "
            f"{[round(v, 3) for v in losses]}")
    del model, batches
    torch.cuda.empty_cache()
    log(f"x8: phase 16 in {time.perf_counter() - t0:.1f} s")
    return checks, launches


# ---------------------------------------------------------------------------
# phase 17: SRFlow at 16x, and the dp / sp steps and predicts
# ---------------------------------------------------------------------------

# 16x: the sampler at LR 32^2 -> HR 512^2 and at a ragged LR (padded to
# even), K5's level shapes those of the 8x sample at LR 64^2, which phase 16
# holds K5 at; the base trainer at B 12 of 160^2 GT over 10^2 LQ
X16_LR, X16_RAGGED_LR = (32, 32), (25, 21)
# the sharded steps (the LINF-LP pixel step, B 16 of 48^2; the SRFlow-LP
# prior step with the eps loss and the SRFlow base model's frozen step, B
# 12 of 160^2), the sp predict at 128^2 -> 512^2 and the dp SRFlow-LP
# predict of 2 LR images of 128^2, one a rank; their images against the
# single predict's within PAR_IMAGE_TOL
# (the step's options, the input its spread is taken under and the signs
# of the nudge: phase 10's + for the LINF-LP step, phases 12 and 14's +-
# for the SRFlow steps)
PAR_STEPS = {
    "linf": ({"vgg_weight": 1.0, "latent_weight": 0.0, "lr": 1e-4,
              "reps": 3}, "gt_lr_up", (1,)),
    "srflow_prior": ({"eps_weight": 1.0, "image_weight": 0.0, "reps": 3},
                     "LQ", (1, -1)),
    "srflow_nll": ({"freeze_rrdb": True, "noise_seed": 0, "reps": 3},
                   "LQ", (1, -1))}
PAR_IMAGE_TOL = 1e-5
# a step's launches in each rank, whatever its share of the batch (the
# encoder and the RRDB on its crops, K2 and K1's forward on its rows, K1's
# inverse on the whole grid, K5 forward in both encodes at B / dp)
PAR_LAUNCHES = {"linf": dict(TRAIN_LAUNCHES),
                "srflow_prior": {"conv3x3_cat": 345, "flow_step_forward": 96},
                "srflow_nll": dict(BASE_TRAIN_LAUNCHES)}


# the spatial SRFlow-LP predict (parallel.sharded 'srflow_sp': one LR's
# width over sp ranks, a halo exchange at every op with a spatial extent):
# the flagship at LR 128^2 -> 512^2 under high and default and the ragged
# LR 101x85 (W padded to 96) under high, each on the kernel path and the
# twin path (kernels=False, the reference check_srflow_predict holds the
# kernel path to); every rank's kernel-path strip within
# parallel.sharded.STRIP_TOL of the single predict's columns of the same
# padded LR (bitwise at NCCL world 1, kernel path only; hold_spatial holds
# the twin path's); a rank's launches those of the single predict.  Where
# a strip leaves the whole image: profiling/spatial_stages.py
PAR_SPATIAL = (("128x128->512x512", LR, "high"),
               ("101x85->404x340", SRFLOW_RAGGED_LR, "high"),
               ("128x128->512x512", LR, "default"))


def run_srflow_x16(dev):
    """Phase 17 (first part): SRFlow at 16x (``bfsr_tpu_torch/configs/
    srflow_df2k_16x.yml``: RRDB 64 x 23, K 16, L 4, hidden 64; K5 at C =
    12, 24, 48 and 192) at full width, random live weights from seed 0:
    ``sample_sr`` in high and default (K3 345, K5 64 reverse a sample),
    timed, staged, profiled; the base step frozen and live; ``validate``.
    Returns {path: launches}."""
    import numpy as np
    import torch

    from bfsr_tpu_torch.entry import (build_srflow_x16,
                                      example_srflow_train_batch)
    from bfsr_tpu_torch.pipelines.srflow_eval import (lr_multiple,
                                                      pad_to_multiple)

    t0 = time.perf_counter()
    model = build_srflow_x16(dev, seed=0)
    widths = sorted({e["c"] for e in model.plan if e["kind"] == "step_cond"})
    log(f"x16: model built from seed 0 in {time.perf_counter() - t0:.2f} s; "
        f"levels on {model.cond_keys()}, conditional steps at C = {widths}, "
        f"final latent {model.final_c} channels")
    rng = np.random.default_rng(16)
    img = torch.as_tensor(rng.random((*X16_LR, 3)), dtype=torch.float32,
                          device=dev)
    ragged = torch.as_tensor(rng.random((*X16_RAGGED_LR, 3)),
                             dtype=torch.float32, device=dev)
    tag = f"{X16_LR[0]}x{X16_LR[1]}->{16 * X16_LR[0]}x{16 * X16_LR[1]}"
    rtag = (f"{X16_RAGGED_LR[0]}x{X16_RAGGED_LR[1]}->"
            f"{16 * X16_RAGGED_LR[0]}x{16 * X16_RAGGED_LR[1]}")
    launches = {}
    for mode in ("high", "default"):
        launches[f"srflow_x16_sample{'' if mode == 'high' else '_default'}"], \
            _ = check_x8_sample(model, img, tag, mode, "x16")
        check_x8_sample(model, ragged, rtag, mode, "x16")
    x = pad_to_multiple(img, lr_multiple(model))
    mp = 256 * X16_LR[0] * X16_LR[1] / 1e6
    medians = time_paths(
        {m: in_mode(m, lambda: x8_decode(model, x, X8_HEATS[1], True))
         for m in ("high", "default")}, mp, f"x16 sample {tag} mode",
        per_block=3)
    for mode in ("high", "default"):
        with precision(mode):
            x8_stages(model, x, f"x16 sample {tag} {mode}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            x8_decode(model, x, X8_HEATS[1], True)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        log(f"x16 sample {tag} {mode}: peak memory {peak / 2**20:.1f} MiB "
            f"({(peak - base) / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB resident)")
        profile_predict(in_mode(mode, lambda: x8_decode(
            model, x, X8_HEATS[1], True)), medians[mode],
            f"x16 sample {tag} {mode}", top=8, what="sample")

    batch = example_srflow_train_batch(dev, 160, SRFLOW_TRAIN_BATCH,
                                       SRFLOW_TRAIN_GT, 16)
    model.prime_actnorms(batch["GT"], batch["LQ"])
    noise = quant_noise(batch, 0)
    label = f"x16 base train step B={SRFLOW_TRAIN_BATCH} {SRFLOW_TRAIN_GT}^2"
    launches["srflow_x16_train"], frozen_twin = check_base_frozen_step(
        model, batch, noise, f"{label} frozen")
    check_base_live_step(model, batch, noise, frozen_twin, f"{label} live")
    del frozen_twin
    # validate on the primed weights, before the timed steps move them: a
    # random flow's NLL climbs for its first steps, and after them samples
    # at heat >= 0.75 overflow on the twin path as on the kernel path (at
    # 8x too: profiling/validate_order_probe.py, PERF.md)
    launches["srflow_x16_validate"] = check_validate(model, dev,
                                                     "x16 validate")
    for form in ("frozen", "live"):
        step = base_train_step(model, form == "frozen")
        torch.cuda.reset_peak_memory_stats()
        losses = []
        time_steps({form: lambda s=step: losses.append(
            s(batch)["loss"])}, f"{label} train", blocks=1, per_block=2)
        peak = torch.cuda.max_memory_allocated()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{label} {form}: losses {losses}")
        log(f"{label} {form}: peak memory {peak / 2**20:.1f} MiB; nll_loss "
            f"over its {len(losses)} steps: {[round(v, 3) for v in losses]}")
    del model, batch
    torch.cuda.empty_cache()
    return launches


def par_inputs():
    """The sharded checks' data (numpy, from seeds): the three steps'
    global batches, the sp predict's inputs and the dp SRFlow-LP LRs."""
    import numpy as np

    from bfsr_tpu_torch.entry import (example_inputs, example_srflow_train_batch,
                                      example_train_batch)

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}

    steps = {"linf": host(example_train_batch("cpu", 170, TRAIN_BATCH,
                                              TRAIN_INP, TRAIN_SCALE_MAX)),
             "srflow_prior": host(example_srflow_train_batch(
                 "cpu", 171, SRFLOW_TRAIN_BATCH, SRFLOW_TRAIN_GT)),
             "srflow_nll": host(example_srflow_train_batch(
                 "cpu", 172, SRFLOW_TRAIN_BATCH, SRFLOW_TRAIN_GT))}
    sp = dict(zip(("inp", "coord", "cell", "gt_lr_up"),
                  (t.numpy() for t in example_inputs("cpu", LR, HR, 0))))
    lrs = np.random.default_rng(173).random((2, *LR, 3)).astype(np.float32)
    return steps, sp, {"lr": lrs}


def spatial_inputs():
    """{tag: the LR image (numpy)} of the spatial predicts (PAR_SPATIAL)."""
    import numpy as np

    rng = np.random.default_rng(174)
    imgs = {}
    for tag, hw, _ in PAR_SPATIAL:
        if tag not in imgs:
            imgs[tag] = rng.random((*hw, 3)).astype(np.float32)
    return imgs


def spatial_cases(imgs, mesh):
    """``run_cases`` entries of the spatial predicts on ``mesh`` (each
    with its ``tag``): each of PAR_SPATIAL on the kernel path (timed: 2
    predicts after the first) and the twin path."""
    cases = []
    for tag, _, mode in PAR_SPATIAL:
        for kernels in (True, False):
            opts = {"kernels": kernels, "mode": mode,
                    "reps": 2 if kernels else 0}
            cases.append({"predict": "srflow_sp", "recipe": {"seed": 0},
                          "inputs": {"lr": imgs[tag]}, "mesh": mesh,
                          "opts": opts, "tag": tag})
    return cases


def par_cases(steps, sp, lrs, mesh):
    """``run_cases`` entries: the three steps on ``mesh`` (the LINF-LP
    step both dp and sp where the mesh has two ranks), the sp and dp
    predicts at two ranks."""
    recipe = {"seed": 0}
    cases = []
    for kind, (opts, _, _) in PAR_STEPS.items():
        r = dict(recipe, prime=True) if kind == "srflow_nll" else recipe
        cases.append({"step": kind, "recipe": r, "batch": steps[kind],
                      "mesh": mesh, "opts": opts})
    if mesh == {"dp": 2}:
        cases.append(dict(cases[0], mesh={"dp": 1, "sp": 2}))
        cases.append({"predict": "linf_sp", "recipe": recipe, "inputs": sp,
                      "mesh": {"sp": 2}})
        cases.append({"predict": "srflow_dp", "recipe": recipe,
                      "inputs": lrs, "mesh": {"dp": 2}})
    return cases


def run_parallel(dev):
    """Phase 17 (second part): the dp / sp wrappers at the flagship widths
    on the card.  The three steps on one process (the reference, and its
    spread under its input nudged by 1 + GRAD_NUDGE); through the dp
    wrappers on NCCL at world 1 in this process; and on two gloo ranks
    sharing this card (``parallel.mesh.spawn``), with the LINF-LP step
    also sp 2, the sp predict, the dp SRFlow-LP predict and the spatial
    SRFlow-LP predict (PAR_SPATIAL, its two strips on the two ranks; at
    world 1 its one strip, the kernel path alone, untimed).  Each step's loss and gradients held to the
    reference as phases 10, 12 and 14 hold the kernel path to the twin
    path (``hold_par``); each predict's images within PAR_IMAGE_TOL of
    the single predict's (``hold_spatial`` for the spatial one, after K3
    and K5 are held to their twins at its strips' shapes).  Returns
    ({path: launches}, the strip checks {kernel: [results]})."""
    import tempfile
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from bfsr_tpu_torch.parallel.mesh import spawn
    from bfsr_tpu_torch.parallel.sharded import (build, compare_strips,
                                                 run_cases, run_predict,
                                                 run_step)
    from bfsr_tpu_torch.pipelines.srflow_eval import strip_multiple

    t0 = time.perf_counter()
    steps, sp, lrs = par_inputs()
    imgs = spatial_inputs()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    launches, refs, ms = {}, {}, {}
    # the spatial predict: K3 and K5 at a strip's shapes, and the single
    # predicts every strip is held to
    sp_models = build("srflow_sp", {"seed": 0}, "cuda")
    strip_checks = check_spatial_kernels(
        sp_models[0], imgs[PAR_SPATIAL[0][0]],
        strip_multiple(2, sp_models[1]))
    sp_singles = spatial_singles(sp_models, imgs)
    log(f"par: spatial set-up (the inputs, the models, K3 / K5 at the "
        f"strips, the single predicts) in {time.perf_counter() - t0:.1f} s")
    models = {}
    for kind, (opts, key, signs) in PAR_STEPS.items():
        recipe = {"seed": 0, "prime": kind == "srflow_nll"}
        models[kind] = build(kind, recipe, "cuda", steps[kind])
        single = run_step(kind, recipe, steps[kind], None, "cuda", opts,
                          models=models[kind])
        nudged = [run_step(kind, recipe, steps[kind], None, "cuda",
                           dict(opts, nudge=(key, 1 + sg * GRAD_NUDGE),
                                reps=0), models=models[kind])
                  for sg in signs]
        refs[kind] = (single, nudged,
                      f"the larger of {key} x (1 +- {GRAD_NUDGE:g})"
                      if len(signs) > 1 else f"{key} x {1 + GRAD_NUDGE:.9g}")
        ms.setdefault(kind, {})["one process"] = single["ms"]
    # NCCL, world 1: the dp wrappers in this process, on the same models
    # (the replication from rank 0 leaves them as they are)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        for case in par_cases(steps, sp, lrs, {"dp": 1}):
            got = run_step(case["step"], case["recipe"], case["batch"],
                           case["mesh"], "cuda", case["opts"],
                           models=models[case["step"]])
            hold_par(f"dp nccl world 1 {case['step']} step", case["step"],
                     [got], refs[case["step"]])
            launches[f"dp_nccl1_{case['step']}"] = got["launches"]
            ms[case["step"]]["nccl world 1"] = got["ms"]
        # the spatial predict's one strip: the single predict's code
        # path (no exchange), so bitwise; the kernel path alone
        t1 = time.perf_counter()
        for c in spatial_cases(imgs, {"sp": 1}):
            tag, o = c["tag"], c["opts"]
            if not o["kernels"]:
                continue
            got = run_predict("srflow_sp", c["recipe"], c["inputs"],
                              c["mesh"], "cuda", dict(o, reps=0),
                              models=sp_models)
            single = sp_singles[tag, o["mode"], True]
            label = f"par: spatial nccl world 1 {tag} {o['mode']}"
            compare_strips(single, [got], label, tol=0.0)
            if got["exchanges"] or got["launches"] != single["launches"]:
                raise RuntimeError(f"{label}: {got['exchanges']} exchanges, "
                                   f"launches {got['launches']} (the single "
                                   f"predict's {single['launches']})")
            launches[f"srflow_sp_nccl1_rank0_{tag}_{o['mode']}"] = \
                got["launches"]
            log(f"{label}: its one strip {got['out'].shape[1]}x"
                f"{got['out'].shape[2]} bitwise the single predict's, 0 "
                f"exchanges, launches {json.dumps(got['launches'])}")
        log(f"par: spatial nccl world 1 in {time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
    del models, sp_models
    torch.cuda.empty_cache()
    # gloo, world 2, both ranks on this card
    t1 = time.perf_counter()
    cases = par_cases(steps, sp, lrs, {"dp": 2})
    sp_cases = spatial_cases(imgs, {"sp": 2})
    ranks = spawn(run_cases, 2, "gloo", args=(cases + sp_cases, "cuda"),
                  store_dir=tmp, init_timeout=120.0, join_timeout=400.0,
                  threads=4, device="cuda:0")
    log(f"par: gloo world 2 (two ranks sharing this card): spawned, ran "
        f"{len(cases) + len(sp_cases)} cases and joined in "
        f"{time.perf_counter() - t1:.1f} s")
    log_spatial("par: spatial gloo world 2",
                [[r[len(cases) + i] for r in ranks]
                 for i in range(len(sp_cases))], sp_cases, sp_singles,
                launches)
    for i, case in enumerate(cases):
        got = [r[i] for r in ranks]
        if "step" in case:
            where = "x".join(f"{k}{v}" for k, v in case["mesh"].items())
            hold_par(f"{where} gloo world 2 {case['step']} step",
                     case["step"], got, refs[case["step"]])
            for r, g in enumerate(got):
                launches[f"{where}_gloo2_rank{r}_{case['step']}"] = \
                    g["launches"]
            ms[case["step"]][f"gloo world 2 {where}"] = max(
                g["ms"] for g in got)
            continue
        single = run_predict(case["predict"], case["recipe"], case["inputs"],
                             None, "cuda")
        axis = 1 if case["predict"] == "linf_sp" else 0
        parts = np.split(single["out"], 2, axis=axis)
        for r, (g, want) in enumerate(zip(got, parts)):
            err = float(np.abs(g["out"] - want).max())
            if g["out"].shape != want.shape or not err <= PAR_IMAGE_TOL:
                raise RuntimeError(
                    f"{case['predict']} rank {r}: shape {g['out'].shape} "
                    f"(expected {want.shape}), max abs err {err:.3e} against "
                    f"the single predict (tol {PAR_IMAGE_TOL:g})")
            launches[f"{case['predict']}_gloo2_rank{r}"] = g["launches"]
            log(f"par: {case['predict']} gloo world 2 rank {r}: its part "
                f"{g['out'].shape} within {err:.3e} of the single predict's "
                f"(tol {PAR_IMAGE_TOL:g}); launches "
                f"{json.dumps(g['launches'])}; {g['ms']:.1f} ms (single "
                f"{single['ms']:.1f} ms)")
    log("par: the two gloo ranks share one card and the host's cores: the "
        "ms below compare paths, not scaling (no scaling number is claimed)")
    for kind, by in ms.items():
        log(f"par: ms per step (loss and gradients) {kind}: "
            + ", ".join(f"{k} {v:.1f}" for k, v in by.items()))
    log(f"par: phase 17's sharded part in {time.perf_counter() - t0:.1f} s")
    return launches, strip_checks


def log_spatial(label, results, cases, singles, launches):
    """``hold_spatial`` of each PAR_SPATIAL case's ranks (``results``: per
    case of ``cases``, the ranks' results), its kernel path beside its
    twin path; each rank's launches into ``launches``."""
    by = {}
    for case, got in zip(cases, results):
        o = case["opts"]
        by[case["tag"], o["mode"], o["kernels"]] = got
    for tag, _, mode in PAR_SPATIAL:
        ranks = by[tag, mode, True]
        log(hold_spatial(label, tag, mode, ranks, by[tag, mode, False],
                         singles[tag, mode, True], singles[tag, mode, False]))
        for r, got in enumerate(ranks):
            launches[f"srflow_sp_gloo2_rank{r}_{tag}_{mode}"] = \
                got["launches"]


def check_spatial_kernels(model, img, multiple):
    """K3 (f32 and bf16) at the RRDB's conv4 and conv5 and K5 (f32 and the
    served one-pass form, both ways) at each flow level, at the shapes a
    strip gives them: rank 0's LR strip of ``img`` padded for two ranks
    (``multiple``), with its one column of halo for K3 and its two for
    K5, on the first conditional step of each level and its record.
    Returns {kernel: [results]}."""
    import torch

    from bfsr_tpu_torch.ops.cuda import flow_step as k5
    from bfsr_tpu_torch.ops.halo import STEP_HALO
    from bfsr_tpu_torch.pipelines.srflow_eval import pad_strips

    lr = pad_strips(torch.as_tensor(img, device="cuda"), multiple)
    w = lr.shape[2] // 2
    strip = lr[:, :, :w + 1]
    results = {}
    for label, *case in rrdb_k3_cases(model, strip):
        label = (f"{label.rsplit(' @', 1)[0]} @{strip.shape[1]}x"
                 f"{strip.shape[2]} (a strip with its halo)")
        results.setdefault("conv3x3_cat", []).append(check_k3(label, *case))
        results.setdefault("conv3x3_cat_bf16", []).append(
            check_k3_bf16(label, *case))
    gen = torch.Generator(device="cuda").manual_seed(6)
    for e, step, rec in first_steps(model, lr):
        c, hid = e["c"], step.hidden
        rec = rec[:, :, :rec.shape[2] // 2 + STEP_HALO].contiguous()
        b, h, w = rec.shape[:3]
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        where = f" strip level {e['level']} ({b}, {h}, {w}, {c})"
        for form, buf, mode in (
                (None, step.kpacked, "high"),
                (step.step_form, step.kpacked_bf16, "default")):
            cost = k5.k5_cost(c, hid, (h, w), buf, form or "f32")
            with precision(mode), torch.inference_mode():
                if form is None:
                    fwd = ("flow_step_forward", k5.flow_step_forward_plain)
                    rev = ("flow_step_reverse", k5.flow_step_reverse_plain)
                else:
                    fwd, rev = (k5.BF16_FORMS[form, False],
                                k5.BF16_FORMS[form, True])
                y = fwd[1](x, rec, buf, hid)
                for (name, plain), fn, inp in (
                        (fwd, k5.flow_step_forward, x),
                        (rev, k5.flow_step_reverse, y)):
                    r = compare(
                        name, lambda: fn(inp, rec, step.kpacked, hid,
                                         step.kpacked_bf16, step.step_form),
                        lambda: plain(inp, rec, buf, hid), TOL[name],
                        label=f" {form or 'f32'}{where}", cost=cost)
                    results.setdefault(name, []).append(
                        dict(r, width=c, shape=[b, h, w]))
    return results


def spatial_singles(models, imgs):
    """{(tag, mode, kernels): ``run_predict``'s 'srflow_sp' on one process
    (``SRFlowLPPredictor.run`` on the LR padded for two ranks, which the
    flagship's 16 columns a rank pad as for one)} of each spatial case;
    the kernel path's launches held to a predict's (K3 363, K5 48 + 48
    in the mode's forms)."""
    from bfsr_tpu_torch.parallel.sharded import run_predict
    from bfsr_tpu_torch.pipelines.srflow_eval import strip_multiple

    for tag, img in imgs.items():
        w = img.shape[1]
        pads = {n: -(-w // strip_multiple(n, models[1]))
                * strip_multiple(n, models[1]) for n in (1, 2)}
        if pads[1] != pads[2]:
            raise ValueError(f"spatial {tag}: one rank pads W to {pads[1]}, "
                             f"two to {pads[2]}: world 1 has no single "
                             "predict to match")

    n_cond = sum(e["kind"] == "step_cond" for e in models[0].plan)
    want = {"high": {"conv3x3_cat": 363, "flow_step_forward": n_cond,
                     "flow_step_reverse": n_cond},
            "default": {"conv3x3_cat_bf16": 363,
                        "flow_step_bf16_forward": n_cond,
                        "flow_step_bf16_reverse": n_cond}}
    out = {}
    for case in spatial_cases(imgs, None):
        o, tag = case["opts"], case["tag"]
        single = run_predict("srflow_sp", case["recipe"], case["inputs"],
                             None, "cuda", dict(o, sp=2), models=models)
        if o["kernels"] and single["launches"] != want[o["mode"]]:
            raise RuntimeError(f"spatial single {tag} {o['mode']}: launches "
                               f"{single['launches']}, expected "
                               f"{want[o['mode']]}")
        out[tag, o["mode"], o["kernels"]] = single
    return out


def hold_spatial(label, tag, mode, ranks, twins, single, twin_single):
    """The spatial predict's ranks (``ranks``: the kernel path's results,
    ``twins``: the twin path's) against the single predict's
    (``parallel.sharded.compare_strips``): each rank's kernel-path strip
    within STRIP_TOL of its columns, its twin-path strip within the limits
    below, its launches the single predict's, and its kernel path against
    its twin path at ``check_srflow_predict``'s limits (under default,
    ``check_srflow_default``'s PSNR floor).  Returns a log line."""
    import numpy as np
    import torch

    from bfsr_tpu_torch.parallel.sharded import STRIP_TOL, compare_strips
    from bfsr_tpu_torch.profiling.mode_agreement import agreement_db

    label = f"{label} {tag} {mode}"
    errs = compare_strips(single, ranks, f"{label} kernel path")
    # the twin path's strips: its convs all run on cuDNN, whose sums at a
    # strip's width may take another order than at the whole image's (the
    # ragged strips' prior moved 1.5e-8, the decode took it to 1.8e-5,
    # PERF.md §6), so they are held as check_srflow_predict holds a
    # path whose sums differ: clipped TOL['srflow_image'], unclipped
    # TOL['srflow_unclipped_rel'] of the largest value
    twin_tol = TOL["srflow_unclipped_rel"] * float(
        np.abs(twin_single["out"]).max())
    twin_errs = compare_strips(twin_single, twins, f"{label} twin path",
                               twin_tol)

    def clipped(res):
        return dict(res, out=np.clip(res["out"], 0, 1))

    compare_strips(clipped(twin_single), [clipped(t) for t in twins],
                   f"{label} twin path clipped", TOL["srflow_image"])
    paths = []
    for r, (got, twin) in enumerate(zip(ranks, twins)):
        if got["launches"] != single["launches"]:
            raise RuntimeError(f"{label}: rank {r} launches "
                               f"{got['launches']}, the single predict's "
                               f"{single['launches']}")
        k, t = torch.as_tensor(got["out"]), torch.as_tensor(twin["out"])
        kc, tc = k.clamp(0, 1), t.clamp(0, 1)
        if mode == "default":
            db = agreement_db(kc, tc)
            ok, vs = db >= TOL["srflow_default_twin_db"], (
                f"{db:.3f} dB (floor {TOL['srflow_default_twin_db']:g})")
        else:
            err = float((kc - tc).abs().max())
            rel = float((k - t).abs().max()) / float(t.abs().max())
            ok = (err <= TOL["srflow_image"]
                  and rel <= TOL["srflow_unclipped_rel"])
            vs = (f"max abs {err:.3e} (tol {TOL['srflow_image']:g}), "
                  f"unclipped rel {rel:.3e} (tol "
                  f"{TOL['srflow_unclipped_rel']:g})")
        if not (ok and torch.isfinite(k).all()):
            raise RuntimeError(f"{label}: rank {r} kernel path vs twin path "
                               f"{vs}")
        paths.append(f"rank {r}: {got['ms']:.1f} ms, {got['exchanges']} "
                     f"exchanges, {got['bytes']} bytes; kernel vs twin "
                     f"path {vs}")
    return (f"{label}: {len(ranks)} strips of "
            f"{ranks[0]['out'].shape[1]}x{ranks[0]['out'].shape[2]}, each "
            f"within {max(errs):.3e} of the single predict's columns (tol "
            f"{STRIP_TOL:g}; single {single['ms']:.1f} ms), the twin path's "
            f"within {max(twin_errs):.3e} of its single predict's (tol "
            f"{twin_tol:.3e}); launches "
            f"{json.dumps(ranks[0]['launches'])} a rank; " + "; ".join(paths))


def hold_par(label, kind, ranks, ref):
    """The ranks' results of a sharded step against the single-process
    step's (``parallel.sharded.compare_steps``: the loss within 1e-5
    relative, each gradient within twice the worst spread of the step
    under its input nudged, at least 1e-3 and at most 0.5, as
    ``hold_step`` holds the kernel path to the twin path; the ranks
    alike), each rank's launches PAR_LAUNCHES[kind]."""
    from bfsr_tpu_torch.parallel.sharded import compare_steps

    single, nudged, nudge = ref
    for r, got in enumerate(ranks):
        if got["launches"] != PAR_LAUNCHES[kind]:
            raise RuntimeError(f"par: {label}: rank {r} launches "
                               f"{got['launches']}, expected "
                               f"{PAR_LAUNCHES[kind]}")
    log(compare_steps(single, ranks, f"par: {label}", nudged)
        + f" (the spread under {nudge}); launches "
        f"{json.dumps(ranks[0]['launches'])} a rank, "
        + ", ".join(f"{g['ms']:.1f}" for g in ranks) + " ms")


# ---------------------------------------------------------------------------
# phase 19: the learning curves
# ---------------------------------------------------------------------------

# each curve's steps (the JAX curves had dropped ~10x / ~27 bits / ~2x by
# step 100; the LINF prior's held-out PSNR passes no prior's only once its
# loss leaves the plateau it holds from ~step 50 to ~500: against 19.94 dB
# it read 18.39 after 300 steps, 20.37 after 600, 22.73 after 700 and
# 24.63 after 800, PERF.md §6) and a step's launches: phase 10's step
# with the latent loss less the VGG term's decode (K1's inverse), phase
# 14's frozen step (BASE_TRAIN_LAUNCHES), phase 12's step with the image
# loss
CURVE_STEPS = {"linf": 800, "srflow": 200, "prior": 200}
CURVE_LAUNCHES = {
    "linf": {**{k: v for k, v in TRAIN_LAUNCHES.items()
                if k != "linf_flow_inverse"}, "linf_flow_forward": 2},
    "srflow": dict(BASE_TRAIN_LAUNCHES),
    "prior": {"conv3x3_cat": 345, "flow_step_forward": 96,
              "flow_step_reverse": 48}}
# the earlier phases' counts of the same steps, where main() has them
CURVE_EARLIER = {"srflow": "srflow_base_train",
                 "prior": "srflow_train_image"}
# tests/test_torch_convergence.py's holds on the mean of the last 10
# losses against the first 5 (a ratio, or a drop in bits/dim for the NLL)
# and on the trained weights' held-out margins over each baseline (PSNR in
# dB above it, NLL in bits/dim below it)
CURVE_HOLDS = {
    "linf": {"ratio": 0.25, "psnr": {"no prior": 1.0, "init": 1.0}},
    "srflow": {"drop": 1.0, "psnr": {"init": 1.0}, "nll": {"init": 1.0}},
    "prior": {"ratio": 0.5, "psnr": {"no prior": 2.0, "init": 2.0}}}


def hold_curve(name, curve, want):
    """A curve's holds: every loss and held-out metric finite, every
    step's launches ``want``, the loss's fall and each held-out margin of
    CURVE_HOLDS.  Raises on the first that fails."""
    import math

    from bfsr_tpu_torch.profiling import learnable_task

    losses = curve["losses"]
    metrics = [v for vs in curve["held_out"].values() for v in vs.values()]
    if not all(math.isfinite(v) for v in losses + metrics):
        raise RuntimeError(f"curve {name}: a loss or held-out metric is not "
                           f"finite: {curve['held_out']}")
    off = [(i, n) for i, n in enumerate(curve["launches"]) if n != want]
    if off:
        raise RuntimeError(f"curve {name}: {len(off)} of {len(losses)} steps "
                           f"launched other than {want} a step, first "
                           f"{off[:3]}")
    first, last = learnable_task.summary(losses, 5, 10)
    hold = CURVE_HOLDS[name]
    held = []
    if "ratio" in hold:
        held.append((f"last 10 / first 5 {last / first!r} < {hold['ratio']}",
                     last < hold["ratio"] * first))
    if "drop" in hold:
        held.append((f"first 5 - last 10 {first - last!r} > {hold['drop']}",
                     last < first - hold["drop"]))
    for metric, sign in (("psnr", 1.0), ("nll", -1.0)):
        values = curve["held_out"].get(metric, {})
        for base, margin in hold.get(metric, {}).items():
            gain = sign * (values["trained"] - values[base])
            held.append((f"{metric} trained - {base} {sign * gain!r} "
                         f"{'>' if sign > 0 else '<'} {sign * margin:g}",
                         gain > margin))
    failed = [what for what, ok in held if not ok]
    if failed:
        raise RuntimeError(f"curve {name}: {'; '.join(failed)}")
    log(f"curve {name}: held: {len(losses)} steps of {want} launches each; "
        + "; ".join(what for what, _ in held))


def run_curves(dev, earlier=None):
    """Phase 19: the three learning curves at full width on the kernels
    (``bfsr_tpu_torch/profiling/*train_curve.py``), each held by
    ``hold_curve``; ``earlier``: main()'s launches by path, whose steps of
    phases 12 and 14 must have launched what a curve's step does."""
    import torch

    from bfsr_tpu_torch.profiling import (prior_train_curve,
                                          srflow_train_curve, train_curve)

    t19 = time.perf_counter()
    for name, curve_module in (("linf", train_curve),
                               ("srflow", srflow_train_curve),
                               ("prior", prior_train_curve)):
        want = CURVE_LAUNCHES[name]
        key = CURVE_EARLIER.get(name)
        if earlier and key in earlier and earlier[key] != want:
            raise RuntimeError(f"curve {name}: the earlier phases' step "
                               f"{key!r} launched {earlier[key]}, a curve "
                               f"step expects {want}")
        t0 = time.perf_counter()
        curve = curve_module.run(CURVE_STEPS[name], dev, log=log)
        hold_curve(name, curve, want)
        log(f"curve {name}: {time.perf_counter() - t0:.1f} s")
        del curve
        torch.cuda.empty_cache()
    log(f"phase 19 in {time.perf_counter() - t19:.1f} s")


def main():
    sys.path.insert(0, str(ROOT))
    try:
        import bfsr_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: cannot import {e.name!r} (searched {ROOT} and "
              "sys.path): run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    import numpy as np

    from bfsr_tpu_torch.entry import (build_flagship, build_linf_patch,
                                      build_srflow_lp, example_inputs,
                                      example_patch_inputs)
    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
    from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    cuda.library()
    log(f"build: kernels built and loaded in {cuda.build_seconds:.2f} s")
    ptxas = cuda.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                log(f"ptxas: {line.strip()}")

    # --- phase 18, run here: the native host library, the loader profile
    run_native()

    # --- LINF-LP ---
    dev = torch.device("cuda")
    model, prior = build_flagship(dev, seed=0)
    inputs = example_inputs(dev, LR, HR, seed=0)
    ragged = example_inputs(dev, RAGGED_LR, RAGGED_HR, seed=0)

    checks = check_kernels(model, prior, inputs, ragged)
    launches = {"linf": check_predict(model, prior, inputs, "128x128->512x512")}
    check_predict(model, prior, ragged, "96x80->300x250")
    medians = {}
    for tag, inp in (("128x128->512x512", inputs), ("96x80->300x250", ragged)):
        paths = {k: (lambda p=LINFPredictor(model, prior, kernels=k == "kernel"),
                     a=inp: p.predict(*a)) for k in ("twin", "kernel")}
        mp = inp[1].shape[1] * inp[1].shape[2] / 1e6
        medians[tag] = time_paths(paths, mp, tag)
    profile_predict(lambda: LINFPredictor(model, prior).predict(*inputs),
                    medians["128x128->512x512"]["kernel"], "linf 512^2")

    # --- the bf16 serving modes, LINF-LP ---
    for case in linf_k3_cases(model, prior):
        checks.setdefault("conv3x3_cat_bf16", []).append(check_k3_bf16(*case))
    k6 = k6_cases(prior)
    checks["conv3x3_fused"] = check_k6(k6)
    launches["k6_entry"] = run_k6_entry(k6)
    probe, launches["probe"] = run_probe()
    checks["conv_probe"] = [probe]
    for mode in ("mixed", "default"):
        launches[f"linf_{mode}"] = check_predict_mode(
            model, prior, inputs, "128x128->512x512", mode)
        check_predict_mode(model, prior, ragged, "96x80->300x250", mode)
    for tag, inp in (("128x128->512x512", inputs), ("96x80->300x250", ragged)):
        paths = {m: in_mode(m, lambda p=LINFPredictor(model, prior), a=inp:
                            p.predict(*a)) for m in ("high", "mixed", "default")}
        mp = inp[1].shape[1] * inp[1].shape[2] / 1e6
        medians[f"{tag} modes"] = time_paths(paths, mp, f"{tag} mode")
    for mode in ("mixed", "default"):
        profile_predict(in_mode(mode, lambda: LINFPredictor(model, prior)
                                .predict(*inputs)),
                        medians["128x128->512x512 modes"][mode],
                        f"linf 512^2 {mode}")
    del model, prior, inputs, ragged

    # --- LINF-LP, patch model ---
    t0 = time.perf_counter()
    pmodel, pprior = build_linf_patch(dev, seed=0)
    log(f"patch: model built from seed 0 in {time.perf_counter() - t0:.2f} s")
    pinputs = example_patch_inputs(dev, LR, PATCH_GRID, seed=0)
    pragged = patch_ragged_inputs(dev, seed=0)
    for name, rs in check_patch_kernels(pmodel, pinputs, pragged).items():
        checks.setdefault(name, []).extend(rs)
    launches["linf_patch"] = check_patch_predict(pmodel, pprior, pinputs,
                                                 "128x128->516x516")
    check_patch_predict(pmodel, pprior, pragged, "101x85->404x340 (405x342)")
    for tag, inp in (("patch 128x128->516x516", pinputs),
                     ("patch 101x85->135x114 grid", pragged)):
        paths = {k: (lambda p=LINFPredictor(pmodel, pprior,
                                            kernels=k == "kernel"),
                     a=inp: p.predict(*a)) for k in ("twin", "kernel")}
        mp = 9 * inp[1].shape[1] * inp[1].shape[2] / 1e6
        medians[tag] = time_paths(paths, mp, tag)
    profile_predict(lambda: LINFPredictor(pmodel, pprior).predict(*pinputs),
                    medians["patch 128x128->516x516"]["kernel"], "patch 516^2")
    check_patch_eval(pmodel, pprior)
    del pmodel, pprior, pinputs, pragged

    # --- SRFlow-LP ---
    t0 = time.perf_counter()
    smodel, sprior = build_srflow_lp(dev, seed=0)
    log(f"srflow: flagship built from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    lr = torch.as_tensor(rng.random((*LR, 3)), dtype=torch.float32,
                         device=dev)
    lr_ragged = torch.as_tensor(rng.random((*SRFLOW_RAGGED_LR, 3)),
                                dtype=torch.float32, device=dev)
    for name, rs in check_srflow_kernels(smodel, lr[None]).items():
        checks.setdefault(name, []).extend(rs)
    launches["srflow"] = check_srflow_predict(smodel, sprior, lr,
                                              "128x128->512x512")
    check_srflow_predict(smodel, sprior, lr_ragged, "101x85->404x340")
    for tag, img in (("srflow 128x128->512x512", lr),
                     ("srflow 101x85->404x340", lr_ragged)):
        paths = {k: (lambda p=SRFlowLPPredictor(smodel, sprior,
                                                kernels=k == "kernel"),
                     a=img: p.predict(a)) for k in ("twin", "kernel")}
        mp = 16 * img.shape[0] * img.shape[1] / 1e6
        medians[tag] = time_paths(paths, mp, tag)
    profile_srflow_stages(smodel, sprior, lr, "srflow 512^2")
    profile_predict(lambda: SRFlowLPPredictor(smodel, sprior).predict(lr),
                    medians["srflow 128x128->512x512"]["kernel"],
                    "srflow 512^2", top=16)

    # --- the bf16 serving modes, SRFlow-LP: mixed, then default ---
    launches["srflow_mixed"] = check_srflow_mixed(
        smodel, sprior, lr, "128x128->512x512", launches["srflow"])
    for name, rs in check_srflow_kernels_bf16(smodel, lr[None]).items():
        checks.setdefault(name, []).extend(rs)
    launches["srflow_default"] = check_srflow_default(
        smodel, sprior, lr, "128x128->512x512", launches["srflow"])
    check_srflow_default(smodel, sprior, lr_ragged, "101x85->404x340",
                         launches["srflow"])
    launches["srflow_default_pallas"] = check_srflow_default_pallas(
        smodel, sprior, lr, "128x128->512x512", launches["srflow"])
    for tag, img in (("srflow 128x128->512x512", lr),
                     ("srflow 101x85->404x340", lr_ragged)):
        paths = {m: in_mode(m, lambda p=SRFlowLPPredictor(smodel, sprior),
                            a=img: p.predict(a))
                 for m in ("high", "mixed", "default")}
        mp = 16 * img.shape[0] * img.shape[1] / 1e6
        medians[f"{tag} modes"] = time_paths(paths, mp, f"{tag} mode")
    for mode in ("mixed", "default"):
        with precision(mode):
            profile_srflow_stages(smodel, sprior, lr, f"srflow 512^2 {mode}")
    profile_predict(in_mode("default", lambda: SRFlowLPPredictor(
        smodel, sprior).predict(lr)),
        medians["srflow 128x128->512x512 modes"]["default"],
        "srflow 512^2 default", top=16)

    del smodel, sprior
    torch.cuda.empty_cache()

    # --- the LINF-LP trainer ---
    train_checks, launches["linf_train"], pixel, pixel_batches = \
        run_trainer(dev)

    # --- the LINF-LP patch trainer, and both trainers under mixed / default
    patch_checks, launches["linf_patch_train"], patch, patch_batches = \
        run_patch_trainer(dev)
    for name, rs in patch_checks.items():
        train_checks.setdefault(name, []).extend(rs)
    launches.update(run_train_modes({
        "train": (pixel, pixel_batches, dict(TRAIN_LAUNCHES)),
        "patch train": (patch, patch_batches, dict(PATCH_TRAIN_LAUNCHES))}))
    del pixel, pixel_batches, patch, patch_batches
    torch.cuda.empty_cache()

    # --- the SRFlow-LP prior trainer, in high, mixed and default ---
    srflow_checks, srflow_launches = run_srflow_trainer(dev)
    for name, rs in srflow_checks.items():
        train_checks.setdefault(name, []).extend(rs)
    launches.update(srflow_launches)
    torch.cuda.empty_cache()

    # --- the evaluation entry points ---
    launches.update(run_eval(dev))
    torch.cuda.empty_cache()

    # --- SRFlow base-model training, validate, plain-SR training ---
    launches.update(run_srflow_base_trainer(dev))
    torch.cuda.empty_cache()

    # --- LINF-LP's other encoders and latent modules ---
    other_checks, other_launches, plain_convs = run_other_encoders(dev)
    launches.update(other_launches)
    torch.cuda.empty_cache()

    # --- SRFlow at 8x: the L 4 flow, K5 at C = 48 and 192 ---
    x8_checks, x8_launches = run_srflow_x8(dev)
    launches.update(x8_launches)
    torch.cuda.empty_cache()

    # --- SRFlow at 16x; the dp / sp wrappers on NCCL and gloo ---
    t17 = time.perf_counter()
    launches.update(run_srflow_x16(dev))
    par_launches, strip_checks = run_parallel(dev)
    launches.update(par_launches)
    log(f"phase 17 in {time.perf_counter() - t17:.1f} s")

    # --- the learning curves ---
    run_curves(dev, launches)
    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all, the kernels' "
        "build included")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rs = checks[name]
        # K1 / K2 / K4: the first (flagship-shape) check; K3 (both forms)
        # and K6: the sum of their shapes; K5 (each form): the sum of its
        # three levels (one launch each); the probe: its one shape
        timed = rs if name.startswith(("conv3x3", "flow_step")) else rs[:1]
        by_path = {p: ls[name] for p, ls in launches.items()
                   if ls.get(name)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": timed[0]["bound_by"],
            "bound_rate": timed[0]["bound_rate"],
            "library_ms": (sum(r["library_ms"] for r in timed)
                           if timed[0]["library_ms"] is not None else None),
        })
        if name in train_checks:
            # the trainers' shapes (both K3s at B = 16 and 12, K2's
            # batched crops at out 60 and 540, K4 at N = 36,864, K5 at
            # B = 12) and, for K1's, K4's and K5's inverse, FlowInverse's
            # and FlowStepReverse's gradient, each check as it ran
            kernels[-1]["train_checks"] = [
                {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in train_checks[name]]
        if name in other_checks:
            # phase 15: the RRDB encoder's conv4 / conv5 at LR 128^2 B 1
            # and at 48^2 B 16, edsr-baseline-latent's body conv at 512^2
            kernels[-1]["other_encoder_checks"] = [
                {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in other_checks[name]]
        if name in x8_checks:
            # phase 16: K5 at each level of the 8x flow (C = 12, 24, 48,
            # 192), the sample's shapes at LR 64^2 and the trainer's B 12
            kernels[-1]["x8_checks"] = [
                {k: r[k] for k in ("width", "shape", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "bound_rate", "library_ms")}
                for r in x8_checks[name]]
        if name in strip_checks:
            # phase 17: K3 (both forms) and K5 (f32 and the served one-pass
            # form) at the shapes of the spatial predict's strips with
            # their halos (rank 0 of two at 512^2)
            kernels[-1]["strip_checks"] = [
                {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in strip_checks[name]]
    log(f"plain convs (no K3 takes their Cout): {json.dumps(plain_convs)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
