"""SRFlow-LP learned-prior inference, SRFlow validation and sampling, on
one device.

The counterpart of ``bfsr_tpu/pipelines/srflow_eval.py``'s
``SRFlowLPPredictor``, ``validate`` and ``sample_sr``.  ``validate`` (the
reference's ``SRFlowModel.test()``) and ``sample_sr`` first ``freeze()``
the model on its current weights (a trainer's weights move: K5's packs
and K3's layouts would be stale), then run the RRDB once a batch (K3) and
decode each heat x sample on K5's reverse, each split's eps drawn from a
``torch.Generator`` seeded per batch (``seed + batch index``) on the
model's device; ``validate``'s NLL runs on the unfused log-det encode
(``normal_flow_nll``: K5 drops the log-det).  ``kernels=False`` or
``TWINS`` runs the same on the twins.

The predictor, per LR image (batch 1):

1. pad H and W to a multiple of ``pad_multiple`` (the protocol's 2 at
   least): reflect-pad to even, or for a larger multiple, as the JAX
   predictor does, pad with the image's mirror (numpy's 'symmetric');
2. bilinear up x4 (the image the flow encodes);
3. the RRDB conditioning (K3 on CUDA for the dense blocks) with the
   nearest-up block stack appended (320 channels at the flagship);
4. every conditional step's record, once (``precompute_ft``);
5. encode the LR-up image with no quantisation noise (48 K5 launches at
   the flagship);
6. standardise each eps per pixel over channels (ddof=1);
7. the two-branch UNet prior (K3 at full resolution);
8. decode the learned epses (48 K5 launches);
9. clip to [0, 1] and crop back to the unpadded image's SR.

``kernels=True`` runs each stage's kernel wrapper (the CUDA kernel for a
CUDA tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the
plain twins and the unfused flow steps on any device, the reference the
kernel path is held to.  The kernels take any extent: a larger
``pad_multiple`` buckets shapes for the JAX compiler and here only
changes the border, as there.

Precision modes (``ops/nn.py``): step 7 is the ``prior`` stage, so under
``mixed`` the prior's convs take bf16 operands (its 18 full-resolution
convs on the bf16 K3) while the RRDB, the conditioning and K5 stay f32.
Under ``default`` every stage is bf16: the RRDB's 345 dense-block convs
on the bf16 K3 and its other convs through ``fnn.conv2d``, the
conditioning records (``cond_affine_cache_batched``), the split's conv,
the 96 conditional steps on K5's one-pass form and the prior as under
``mixed``; the unconditional steps' folded actnorm + invconv stays f32,
as in the JAX package.  The one-pass form is the one the flow was frozen
with (``SRFlowNet.freeze(step_form=...)``): ``"xla"`` by default, the JAX
predictor's numerics (the folds f32, as its XLA step), or ``"pallas"``,
the JAX FlowStep kernel's.
"""

import numpy as np
import torch
import torch.nn.functional as F

from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import TWINS
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw

STAGES = ("rrdb", "precompute_ft", "encode", "prior", "decode")


def pad_to_multiple(lr_img01, multiple=2):
    """(h, w, 3) -> (1, h', w', 3), h' and w' the next multiples of
    ``multiple`` (at least 2), padded at the bottom and right: reflected
    for the protocol's %2 pad, mirrored with the edge (numpy's
    'symmetric', up to the image's size) for a larger multiple."""
    m = max(2, int(multiple or 2))
    h, w = lr_img01.shape[:2]
    x = lr_img01[None].float()
    if m == 2:
        if h % 2 or w % 2:
            x = nchw_to_nhwc(F.pad(nhwc_to_nchw(x), (0, w % 2, 0, h % 2),
                                   mode="reflect"))
        return x
    hp, wp = -(-h // m) * m, -(-w // m) * m
    x = torch.cat([x, x.flip(1)], 1)[:, :hp]
    return torch.cat([x, x.flip(2)], 2)[:, :, :wp].contiguous()


class SRFlowLPPredictor:
    """Whole-image predictor for a frozen SRFlowNet and its prior."""

    def __init__(self, model, prior_model, kernels=True, pad_multiple=2):
        if not model.flowUpsamplerNet.frozen():
            raise ValueError("freeze() the SRFlow model before predicting")
        self.model = model
        self.prior = prior_model
        self.kernels = kernels
        self.pad_multiple = max(2, int(pad_multiple or 2))

    @torch.inference_mode()
    def run(self, lr, mark=None):
        """lr: (1, h, w, 3) with h, w even (``pad_to_multiple``) -> the SR image (1, 4h, 4w, 3),
        unclipped.  ``mark(stage)``, if given, is called after each of
        ``STAGES``."""
        model, k = self.model, self.kernels
        mark = mark or (lambda stage: None)
        s = model.scale
        h, w = lr.shape[1], lr.shape[2]
        lr_up = resize_bilinear(lr, (h * s, w * s))
        lr_enc = model.rrdb_preprocess(lr, kernels=k)
        mark("rrdb")
        cache = model.precompute_ft(lr_enc)
        mark("precompute_ft")
        epses = model.normal_flow(lr_up, cache, kernels=k)
        mark("encode")
        with fnn.stage("prior"):
            learned = self.prior(standardize_epses(epses), kernels=k)
        mark("prior")
        sr = model.reverse_flow(learned, cache, kernels=k)
        mark("decode")
        return sr

    @torch.inference_mode()
    def predict(self, lr_img01):
        """lr_img01: (h, w, 3) [0, 1] image (a tensor, or a numpy array,
        which goes to the model's device).  Returns the SR image
        (4h, 4w, 3), clipped to [0, 1]."""
        if isinstance(lr_img01, np.ndarray):
            dev = next(self.model.parameters()).device
            lr_img01 = torch.as_tensor(lr_img01, dtype=torch.float32,
                                       device=dev)
        h, w = lr_img01.shape[:2]
        sr = self.run(pad_to_multiple(lr_img01, self.pad_multiple))
        s = self.model.scale
        return torch.clamp(sr[0], 0.0, 1.0)[: h * s, : w * s]


def _refreeze(model):
    """``freeze()`` on the current weights, in the one-pass form the flow
    was frozen with."""
    steps = model.flowUpsamplerNet.steps()
    return model.freeze(steps[0].step_form if steps else "xla")


@torch.no_grad()
def validate(model, batches, heats=(0.0, 0.5, 0.75, 1.0), n_sample=3, seed=0,
             kernels=True):
    """SRFlow validation (``SRFlow_model.py:178-189``): SR samples at each
    heat x ``n_sample`` and the mean NLL of GT (with its quantisation
    noise), in bits/dim.

    batches: an iterable of {'GT': (B, H, W, 3), 'LQ': (B, H/4, W/4, 3)}
    (numpy arrays or tensors; H, W divisible by 2^L).  Returns (the mean
    over batches of each batch's mean NLL, {(heat, i): the first image of
    the last batch's sample i at heat, clipped to [0, 1]})."""
    path = True if kernels is True else TWINS
    _refreeze(model)
    dev = next(model.parameters()).device
    nlls, samples = [], {}
    for bi, batch in enumerate(batches):
        batch = to_device(batch, dev, ("GT", "LQ"))
        lq, gt = batch["LQ"], batch["GT"]
        gen = torch.Generator(device=dev).manual_seed(seed + bi)
        # the conditioning once a batch, shared by every sample and the NLL
        cache = model.precompute_ft(model.rrdb_preprocess(lq, path))
        for heat in heats:
            for i in range(n_sample):
                z = model.sample_z(heat, lq.shape[1:3], lq.shape[0], gen, dev)
                sr = model.reverse_flow([z], cache, path, eps_std=heat,
                                        generator=gen)
                samples[(heat, i)] = torch.clamp(sr[0], 0.0, 1.0)
        _, nll, _ = model.normal_flow_nll(gt, cache, generator=gen)
        nlls.append(float(nll.mean()))
    return float(np.mean(nlls)), samples


@torch.no_grad()
def sample_sr(model, lr_img01, heat=0.0, seed=0, kernels=True):
    """An SR sample of one LR image (h, w, 3) in [0, 1] at temperature
    ``heat`` (``SRFlow_model.get_sr``): reflect-padded to even, decoded on
    K5 from a final latent and split eps drawn from a generator seeded
    with ``seed``, clipped and cropped to (4h, 4w, 3)."""
    path = True if kernels is True else TWINS
    _refreeze(model)
    dev = next(model.parameters()).device
    if isinstance(lr_img01, np.ndarray):
        lr_img01 = torch.as_tensor(lr_img01, dtype=torch.float32, device=dev)
    h, w = lr_img01.shape[:2]
    lr = pad_to_multiple(lr_img01.to(dev), 2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = model.sample_z(heat, lr.shape[1:3], 1, gen, dev)
    sr = model.get_sr(lr, heat, z=z, generator=gen, kernels=path)
    s = model.scale
    return torch.clamp(sr[0], 0.0, 1.0)[: h * s, : w * s]
