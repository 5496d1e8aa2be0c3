"""EDSR-baseline encoder, ``no_upsampling`` (the LINF configs' only mode).

The counterpart of ``bfsr_tpu/models/edsr.py``: head conv3x3 ->
n_resblocks x (conv-relu-conv, residual scaled) -> tail conv3x3 + global
skip, NHWC in and out.  ``forward(x, kernels=True)`` routes every conv
through ``conv3x3_cat`` — the K3 kernel for a CUDA tensor, as
``edsr_apply_fused`` routes every conv through the s2d Pallas kernel —
and ``kernels=False`` runs the plain twin on any device.  Both follow the
stage's precision (the ``encoder`` stage of the LINF predictors): all 34
convs take bf16 operands where it is ``default``.  The residual adds stay
outside the kernel.  ``freeze()`` keeps each conv's weight in K3's
layouts.

``state_dict`` keys are the reference's: ``head.0``, ``body.{i}.body.{0,2}``,
``body.{n_resblocks}``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import (cache_kernel_weight, conv3x3_cat,
                                             conv3x3_cat_twin, k3_conv)
from bfsr_tpu_torch.registry import register


class ResBlock(nn.Module):
    def __init__(self, n_feats):
        super().__init__()
        self.body = nn.Sequential(k3_conv(n_feats, n_feats), nn.ReLU(True),
                                  k3_conv(n_feats, n_feats))


class EDSR(Model):
    def __init__(self, n_resblocks=16, n_feats=64, res_scale=1, scale=2,
                 no_upsampling=True, rgb_range=1, name="edsr-baseline"):
        super().__init__()
        if not no_upsampling:
            raise NotImplementedError("the port runs EDSR as an encoder only "
                                      "(no_upsampling=True)")
        self.registry_name = name
        self.args = dict(n_resblocks=n_resblocks, n_feats=n_feats,
                         res_scale=res_scale, scale=scale,
                         no_upsampling=no_upsampling, rgb_range=rgb_range)
        self.n_feats = n_feats
        self.res_scale = res_scale
        self.out_dim = n_feats
        self.head = nn.Sequential(k3_conv(3, n_feats))
        self.body = nn.ModuleList([ResBlock(n_feats) for _ in range(n_resblocks)]
                                  + [k3_conv(n_feats, n_feats)])
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)

    @torch.no_grad()
    def freeze(self):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                cache_kernel_weight(m)
        cuda.stamp_layouts(self)
        return self

    def forward(self, x, kernels=True, conv=None):
        """x: (B, H, W, 3) -> features (B, H, W, n_feats); both K3s take
        the batch (the trainer's B = 16).  ``conv``: None, or ``conv(t, m,
        act)`` in place of each conv (``chip_smoke.py`` holds each K3
        launch against its twin on the launch's own input through it)."""

        def c(t, m, act=None):
            if conv is not None:
                return conv(t, m, act)
            if kernels:
                return conv3x3_cat([t], m.weight, bias=m.bias, act=act,
                                   kweight=m.kweight,
                                   kweight_bf16=m.kweight_bf16)
            return conv3x3_cat_twin([t], m.weight, bias=m.bias, act=act)

        if kernels:
            cuda.check_layouts(self)
        h0 = c(x, self.head[0])
        res = h0
        for blk in self.body[:-1]:
            h = c(res, blk.body[0], act="relu")
            h = c(h, blk.body[2])
            res = res + h * self.res_scale
        return c(res, self.body[-1]) + h0


@register("edsr-baseline")
def make_edsr_baseline(n_resblocks=16, n_feats=64, res_scale=1, scale=2,
                       no_upsampling=False, rgb_range=1):
    return EDSR(n_resblocks, n_feats, res_scale, scale, no_upsampling,
                rgb_range, "edsr-baseline")
