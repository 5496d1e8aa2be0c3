"""SRFlow-LP learned-prior inference on one device.

The counterpart of ``bfsr_tpu/pipelines/srflow_eval.py``'s
``SRFlowLPPredictor``.  Per LR image (batch 1):

1. reflect-pad to even H and W;
2. bilinear up x4 (the image the flow encodes);
3. the RRDB conditioning (K3 on CUDA for the dense blocks) with the
   nearest-up block stack appended (320 channels at the flagship);
4. every conditional step's record, once (``precompute_ft``);
5. encode the LR-up image with no quantisation noise (48 K5 launches at
   the flagship);
6. standardise each eps per pixel over channels (ddof=1);
7. the two-branch UNet prior (K3 at full resolution);
8. decode the learned epses (48 K5 launches);
9. clip to [0, 1] and crop.

``kernels=True`` runs each stage's kernel wrapper (the CUDA kernel for a
CUDA tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the
plain twins and the unfused flow steps on any device, the reference the
kernel path is held to.  The kernels take any extent, so the pad is the
protocol's %2 only.

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
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw

STAGES = ("rrdb", "precompute_ft", "encode", "prior", "decode")


def pad_to_even(lr_img01):
    """(h, w, 3) -> (1, h + h % 2, w + w % 2, 3), reflect-padded at the
    bottom and right (the protocol's %2 pad)."""
    h, w = lr_img01.shape[:2]
    x = nhwc_to_nchw(lr_img01[None].float())
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), mode="reflect")
    return nchw_to_nhwc(x)


class SRFlowLPPredictor:
    """Whole-image predictor for a frozen SRFlowNet and its prior."""

    def __init__(self, model, prior_model, kernels=True):
        if not model.flowUpsamplerNet.frozen():
            raise ValueError("freeze() the SRFlow model before predicting")
        self.model = model
        self.prior = prior_model
        self.kernels = kernels

    @torch.inference_mode()
    def run(self, lr, mark=None):
        """lr: (1, h, w, 3) with h, w even -> the SR image (1, 4h, 4w, 3),
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
        sr = self.run(pad_to_even(lr_img01))
        s = self.model.scale
        return torch.clamp(sr[0], 0.0, 1.0)[: h * s, : w * s]
