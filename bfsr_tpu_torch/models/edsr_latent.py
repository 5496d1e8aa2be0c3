"""EDSR-style latent module (``edsr-baseline-latent``): the counterpart of
``bfsr_tpu/models/edsr_latent.py`` (the reference's
``LINF-LP/models/edsr_latent.py``).

DenseBlock_5C projections of the latent z and of the LR (stride-3 conv,
LeakyReLU, DenseBlock_5C, bilinear-resized to z's grid), each dim / 2 ->
concat -> ``n_resblocks`` x (conv, LeakyReLU, conv, residual scaled by
``res_scale``) -> a 1x1 conv back to ``in_chans``.  NHWC in and out.

``forward(z, lr, kernels=True)`` runs both dense blocks (Cout 32) and
every body conv (64 -> 64, the LeakyReLU in the epilogue) on
``conv3x3_cat`` (the K3 kernel for a CUDA tensor) over implicit concats,
as the UNet's full-resolution stages run; the first body conv reads the
concat of the two projections without building it.  The stride-3 LR conv
and the 1x1 out conv stay ``fnn.conv2d``.  ``kernels=False`` and the
trainer's ``training=True`` run the reference order through
``fnn.conv2d`` with explicit concats (the path autograd differentiates);
``training=True`` returns ``(out, {})``: no BatchNorm.  ``freeze()``
keeps the K3 convs' weights in K3's layouts.  All paths follow the
stage's precision (the ``prior`` stage).

``state_dict`` keys are the reference's: ``input_proj.conv{1..5}``,
``lr_proj.0``, ``lr_proj.2.conv{1..5}``, ``body.{i}.body.{0,2}``,
``last_conv``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.edsr import ResBlock
from bfsr_tpu_torch.models.swin_latent import init_dense_
from bfsr_tpu_torch.models.unet import DenseBlock5C, k3, lr_embed
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import cache_kernel_weight
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.registry import register


@register("edsr-baseline-latent")
class EDSRLatent(Model):
    registry_name = "edsr-baseline-latent"

    def __init__(self, in_chans, n_resblocks=16, dim=64, res_scale=1,
                 scale=2, rgb_range=1):
        super().__init__()
        self.args = dict(in_chans=in_chans, n_resblocks=n_resblocks, dim=dim,
                         res_scale=res_scale, scale=scale,
                         rgb_range=rgb_range)
        self.res_scale = res_scale
        self.input_proj = DenseBlock5C(in_chans, dim // 2, dim // 2)
        self.lr_proj = nn.Sequential(
            nn.Conv2d(3, in_chans, 3, stride=3, padding=1),
            nn.LeakyReLU(0.2, True), DenseBlock5C(in_chans, dim // 2, dim // 2))
        self.body = nn.ModuleList([ResBlock(dim, nn.LeakyReLU(0.2, True))
                                   for _ in range(n_resblocks)])
        self.last_conv = nn.Conv2d(dim, in_chans, 1)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        init_dense_(self, generator)

    def _k3_convs(self):
        return (self.input_proj.convs() + self.lr_proj[2].convs()
                + [c for blk in self.body for c in (blk.body[0], blk.body[2])])

    @torch.no_grad()
    def freeze(self):
        for c in self._k3_convs():
            cache_kernel_weight(c)
        cuda.stamp_layouts(self)
        return self

    def _out(self, x):
        c = self.last_conv
        return fnn.conv2d(x, c.weight, c.bias)

    def forward(self, z, lr, kernels=True, training=False, generator=None):
        """z: (B, H, W, in_chans); lr: (B, h, w, 3) -> (B, H, W,
        in_chans), or with ``training=True`` ``(out, {})``.  ``generator``
        is accepted for the latent-module interface (no stochastic
        depth)."""
        if training or not kernels:
            out = self._forward_plain(z, lr)
            return (out, {}) if training else out
        cuda.check_layouts(self)
        proj = self.input_proj.forward_cat([z])
        c = self.lr_proj[0]
        e = fnn.leaky_relu(fnn.conv2d(lr, c.weight, c.bias, stride=3,
                                      padding=1))
        e = self.lr_proj[2].forward_cat([e])
        if e.shape[1:3] != proj.shape[1:3]:
            e = resize_bilinear(e, tuple(proj.shape[1:3]))
        blocks = [proj, e]
        x = torch.cat(blocks, -1)
        for blk in self.body:
            h = k3(blocks, blk.body[0], "lrelu")
            x = x + k3([h], blk.body[2], None) * self.res_scale
            blocks = [x]
        return self._out(x)

    def _forward_plain(self, z, lr):
        x = self.input_proj(z)
        x = torch.cat([x, lr_embed(self.lr_proj, lr, x.shape[1:3])], -1)
        for blk in self.body:
            c1, c2 = blk.body[0], blk.body[2]
            h = fnn.leaky_relu(fnn.conv2d(x, c1.weight, c1.bias))
            x = x + fnn.conv2d(h, c2.weight, c2.bias) * self.res_scale
        return self._out(x)

    def apply_bn_updates(self, bn_stats, momentum=0.1):
        """No BatchNorm: nothing to fold."""
