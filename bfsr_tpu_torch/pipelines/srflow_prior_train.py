"""SRFlow-LP latent-module (prior) training: one train step of the prior.

The counterpart of ``bfsr_tpu/pipelines/srflow_prior_train.py:
make_srflow_prior_train_step``, on one device.  A step on a batch of
(GT, LQ) crops, in the JAX step's order:

1. ``lr_up``, the bilinear x4 of LQ;
2. the frozen part, under ``torch.no_grad()`` (JAX's ``stop_gradient``):
   the RRDB conditioning (its dense-block convs on K3, 345 launches on the
   card at the flagship), every conditional step's record once
   (``precompute_ft``: cuDNN), shared by both encodes and the decode, the
   encode of ``lr_up`` (K5's forward, 48 launches) and the per-pixel
   standardisation of its epses;
3. the trainable part: the two-branch prior with batch statistics (plain
   convs: cuDNN, as XLA convs in JAX) in the ``prior`` stage;
4. with ``eps_weight > 0``: the encode of GT (48 more K5 forwards, no
   gradient), then one L1 over both branches' elements, divided by the
   element count of the learned epses;
5. with ``image_weight > 0``: the decode of the learned epses (K5's
   reverse through ``FlowStepReverse``, 48 launches, whose backward is its
   twin's gradient), then the L1 to GT;
6. backward, the optimizer's step on the prior alone, one step of the LR
   schedule, and the batch statistics folded into the BatchNorms' running
   stats.

The JAX step runs the flow through XLA (its FlowStep kernel is batch 1
only); this one runs K5 at the batch.

Precision modes (``ops/nn.py``): only ``prior`` is a stage, as in the JAX
step.  Under ``mixed`` the prior's convs take bf16 operands, forward and
backward, and the frozen part stays f32; under ``default`` every stage
is bf16: the RRDB on the bf16 K3, the records on rounded operands and K5
in the one-pass form the flow was frozen with (the decode's too).

With a ``mesh`` (axis ``dp``) the step is one rank's part of the
dp-sharded prior step of ``tests/test_sharded.py``: the rank's batch is
its B / dp pairs; the frozen RRDB (K3) and both encodes (K5) run on
them; the prior's BatchNorms take the global batch's statistics
(``fnn.data_parallel``), its gradients are averaged over dp before the
optimizer's step, and the metrics are their mean over dp (each rank's
share is equal, so the mean of the ranks' losses is the global loss).

``kernels=False`` runs the same step with every plain twin (``TWINS``: K3's
in the RRDB, K5's in both encodes and the decode), on any device.  With
``kernels=True`` a CUDA batch launches the kernels or raises, and a CPU
batch runs the twins, as each kernel wrapper does: on the CPU the two
paths compute the same bits.
"""

import torch

from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import TWINS
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.parallel.dp import DataParallel
from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.pipelines.losses import l1_loss
from bfsr_tpu_torch.pipelines.srflow_eval import check_prior_flow

BATCH_KEYS = ("GT", "LQ")


def make_srflow_prior_train_step(model, prior, optimizer, eps_weight=1.0,
                                 image_weight=0.0, kernels=True,
                                 scheduler=None, marks=None, mesh=None):
    """``step(batch) -> {'eps_l' and/or 'img_l', 'loss'}`` (floats, one
    host fetch), which updates the prior, its optimizer and its BatchNorm
    running stats in place; ``step.loss_and_grads(batch, frozen=None) ->
    (metrics (tensors), grads {name: tensor}, bn_stats)`` computes the same
    loss and the prior's gradients and changes nothing;
    ``step.frozen(batch)`` the frozen part's values, which
    ``loss_and_grads`` takes as ``frozen``.

    model: a frozen ``SRFlowNet`` (``freeze()`` called); prior: its
    ``SRFlowUNet``; optimizer: over the prior's parameters; scheduler: a
    per-iteration LR scheduler (``train.optim.lr_scheduler``) or None;
    batch: {'GT': (B, H, W, 3), 'LQ': (B, H/4, W/4, 3)} in [0, 1], H and
    W divisible by 2^L (the training crops are 160).  The flow is an L 3
    one (``check_prior_flow``): the two-branch prior reads its two
    epses.  ``marks``: None, or
    a callable that takes the name of each stage as the step enters it
    ('rrdb', 'precompute_ft', 'encode_lr', 'prior', 'encode_gt',
    'decode', 'backward', 'update', then 'end'), for timing them.
    ``mesh``: None, or this rank's mesh (axis ``dp``), the batch then the
    rank's shard; the metrics and gradients are the global step's.
    """
    if eps_weight <= 0 and image_weight <= 0:
        raise ValueError("at least one of eps_weight / image_weight must be "
                         "> 0")
    if not model.flowUpsamplerNet.frozen():
        raise ValueError("freeze() the SRFlow model before training its "
                         "prior")
    check_prior_flow(model)
    device = next(prior.parameters()).device
    mark = marks or (lambda name: None)
    dp = DataParallel(mesh)
    s = model.scale
    path = True if kernels else TWINS

    @torch.no_grad()
    def conditioning(batch):
        lq = batch["LQ"]
        mark("rrdb")
        lr_enc = model.rrdb_preprocess(lq, path)
        mark("precompute_ft")
        return model.precompute_ft(lr_enc)

    @torch.no_grad()
    def encode_lr(batch, cache):
        lq = batch["LQ"]
        lr_up = resize_bilinear(lq, (lq.shape[1] * s, lq.shape[2] * s))
        return standardize_epses(model.normal_flow(lr_up, cache, path))

    @torch.no_grad()
    def encode_gt(batch, cache):
        return (model.normal_flow(batch["GT"], cache, path)
                if eps_weight > 0 else None)

    def frozen_part(batch):
        """{'cache', 'eps_in', 'eps_gt' (None without the eps loss)}."""
        cache = conditioning(batch)
        return {"cache": cache, "eps_in": encode_lr(batch, cache),
                "eps_gt": encode_gt(batch, cache)}

    def losses(batch, fz=None):
        if fz is None:
            cache = conditioning(batch)
            mark("encode_lr")
            eps_in = encode_lr(batch, cache)
        else:
            cache, eps_in = fz["cache"], fz["eps_in"]
        mark("prior")
        with fnn.stage("prior"), dp.scope():
            learned, bn_stats = prior(eps_in, training=True)
        mets = {}
        if eps_weight > 0:
            mark("encode_gt")
            eps_gt = encode_gt(batch, cache) if fz is None else fz["eps_gt"]
            # one L1 over all branch elements (eps0 has 16x the pixels of
            # the final z at 1/16 the channels: equal per-element weight)
            num = sum(torch.sum(torch.abs(lz - tz))
                      for lz, tz in zip(learned, eps_gt))
            den = sum(lz.numel() for lz in learned)
            mets["eps_l"] = num / den * eps_weight
        if image_weight > 0:
            mark("decode")
            sr = model.reverse_flow(learned, cache, path,
                                    differentiable=True)
            mets["img_l"] = l1_loss(sr, batch["GT"]) * image_weight
        mets["loss"] = sum(mets.values())
        return mets, bn_stats

    def loss_and_grads(batch, frozen=None):
        batch = to_device(batch, device, BATCH_KEYS)
        params = dict(prior.named_parameters())
        mets, bn_stats = losses(batch, frozen)
        grads = torch.autograd.grad(mets["loss"], list(params.values()))
        dp.average(grads)
        return dp.metric_tensors(mets), dict(zip(params, grads)), bn_stats

    def step(batch):
        batch = to_device(batch, device, BATCH_KEYS)
        mets, bn_stats = losses(batch)
        mark("backward")
        optimizer.zero_grad(set_to_none=True)
        mets["loss"].backward()
        dp.average_grads(prior.parameters())
        mark("update")
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        prior.apply_bn_updates(bn_stats)
        mark("end")
        return dp.metrics(mets)

    step.loss_and_grads = loss_and_grads
    step.frozen = lambda batch: frozen_part(to_device(batch, device,
                                                      BATCH_KEYS))
    return step
