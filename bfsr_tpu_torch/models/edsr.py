"""EDSR encoders and generators: ``edsr-baseline`` (16 x 64) and the
full ``edsr`` (32 x 256, ``res_scale`` 0.1).

The counterpart of ``bfsr_tpu/models/edsr.py``: head conv3x3 ->
n_resblocks x (conv-relu-conv, residual scaled) -> tail conv3x3 + global
skip, NHWC in and out.  With ``no_upsampling`` (the LINF configs' mode)
the trunk features are the output; otherwise the reference's pixel-shuffle
upsampler (x2 steps for a power of 2, one x3 step for 3) and a last conv
give RGB.

``forward(x, kernels=True)`` routes every trunk conv through
``conv3x3_cat`` — the K3 kernel for a CUDA tensor, as ``edsr_apply_fused``
routes them through the s2d Pallas kernel — and ``kernels=False`` runs
the plain twin on any device.  Both follow the stage's precision (the
``encoder`` stage of the LINF predictors): all 34 convs of the baseline
take bf16 operands where it is ``default``.  The residual adds stay
outside the kernel.  ``freeze()`` keeps each trunk conv's weight in K3's
layouts.  K3 takes the trunk where ``n_feats`` is one of its Cout
(8/16/32/64), as the JAX fused path is gated on ``n_feats <= 64``; the
full EDSR's 256-wide convs, and the upsampler's and the last conv
everywhere, run ``fnn.conv2d`` (XLA convs in the JAX package).

``state_dict`` keys are the reference's: ``head.0``, ``body.{i}.body.{0,2}``,
``body.{n_resblocks}``, and with the upsampler ``tail.0.{0,2,..}`` and
``tail.1``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import (KERNEL_COUTS, cache_kernel_weight,
                                             conv3x3_cat, conv3x3_cat_twin,
                                             k3_conv)
from bfsr_tpu_torch.registry import register


class ResBlock(nn.Module):
    def __init__(self, n_feats, act=None):
        super().__init__()
        self.body = nn.Sequential(k3_conv(n_feats, n_feats),
                                  act or nn.ReLU(True),
                                  k3_conv(n_feats, n_feats))


def upsampler(scale, n_feats):
    """The reference's ``Upsampler`` (no activation): a conv to 4 n_feats
    and a x2 pixel shuffle per factor 2, or one conv to 9 n_feats and a x3
    shuffle."""
    if scale & (scale - 1) == 0:
        steps = [2] * (scale.bit_length() - 1)
    elif scale == 3:
        steps = [3]
    else:
        raise NotImplementedError(scale)
    layers = []
    for r in steps:
        layers += [nn.Conv2d(n_feats, r * r * n_feats, 3, padding=1),
                   nn.PixelShuffle(r)]
    return nn.Sequential(*layers)


def _conv(x, m):
    return fnn.conv2d(x, m.weight, m.bias)


class EDSR(Model):
    def __init__(self, n_resblocks=16, n_feats=64, res_scale=1, scale=2,
                 no_upsampling=True, rgb_range=1, name="edsr-baseline"):
        super().__init__()
        self.registry_name = name
        self.args = dict(n_resblocks=n_resblocks, n_feats=n_feats,
                         res_scale=res_scale, scale=scale,
                         no_upsampling=no_upsampling, rgb_range=rgb_range)
        self.n_feats = n_feats
        self.res_scale = res_scale
        self.no_upsampling = no_upsampling
        self.k3 = n_feats in KERNEL_COUTS
        self.out_dim = n_feats if no_upsampling else 3
        self.head = nn.Sequential(k3_conv(3, n_feats))
        self.body = nn.ModuleList([ResBlock(n_feats) for _ in range(n_resblocks)]
                                  + [k3_conv(n_feats, n_feats)])
        if not no_upsampling:
            self.tail = nn.Sequential(upsampler(scale, n_feats),
                                      nn.Conv2d(n_feats, 3, 3, padding=1))
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)

    def _trunk_convs(self):
        return ([self.head[0]] + [c for blk in self.body[:-1]
                                  for c in (blk.body[0], blk.body[2])]
                + [self.body[-1]])

    @torch.no_grad()
    def freeze(self):
        if self.k3:
            for m in self._trunk_convs():
                cache_kernel_weight(m)
        cuda.stamp_layouts(self)
        return self

    def forward(self, x, kernels=True, conv=None):
        """x: (B, H, W, 3) -> features (B, H, W, n_feats), or with the
        upsampler RGB (B, H s, W s, 3); both K3s take the batch (the
        trainer's B = 16).  ``conv``: None, or ``conv(t, m, act)`` in place
        of each trunk conv (``chip_smoke.py`` holds each K3 launch against
        its twin on the launch's own input through it)."""

        def c(t, m, act=None):
            if conv is not None:
                return conv(t, m, act)
            if not self.k3:
                y = _conv(t, m)
                return fnn.relu(y) if act == "relu" else y
            if kernels:
                return conv3x3_cat([t], m.weight, bias=m.bias, act=act,
                                   kweight=m.kweight,
                                   kweight_bf16=m.kweight_bf16)
            return conv3x3_cat_twin([t], m.weight, bias=m.bias, act=act)

        if kernels and self.k3:
            cuda.check_layouts(self)
        h0 = c(x, self.head[0])
        res = h0
        for blk in self.body[:-1]:
            h = c(res, blk.body[0], act="relu")
            h = c(h, blk.body[2])
            res = res + h * self.res_scale
        res = c(res, self.body[-1]) + h0
        if self.no_upsampling:
            return res
        for m in self.tail[0]:
            if isinstance(m, nn.Conv2d):
                res = _conv(res, m)
            else:
                res = fnn.pixel_shuffle(res, m.upscale_factor)
        return _conv(res, self.tail[1])


@register("edsr-baseline")
def make_edsr_baseline(n_resblocks=16, n_feats=64, res_scale=1, scale=2,
                       no_upsampling=False, rgb_range=1):
    return EDSR(n_resblocks, n_feats, res_scale, scale, no_upsampling,
                rgb_range, "edsr-baseline")


@register("edsr")
def make_edsr(n_resblocks=32, n_feats=256, res_scale=0.1, scale=2,
              no_upsampling=False, rgb_range=1):
    return EDSR(n_resblocks, n_feats, res_scale, scale, no_upsampling,
                rgb_range, "edsr")
