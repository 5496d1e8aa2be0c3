"""Two-branch UNet prior of SRFlow-LP, eval mode, registered
``'srflow-unet'``.

The counterpart of ``bfsr_tpu/models/srflow/unet_prior.py``: branch 0
maps eps0 (6 channels at H/2), branch 1 the final latent (96 channels at
H/8); each is a DenseBlock_5C projection (growth ``dim``, out ``dim``) ->
DoubleConv -> depth-d UNet (maxpool down / bilinear align_corners up +
skip concat) -> 1x1 out conv.  No LR input, unlike the LINF prior.  The
branches are built from the LINF prior's blocks
(``bfsr_tpu_torch/models/unet.py``) and routed the same way: with
``kernels=True`` the full-resolution stages (the dense projection, ``inc``
and the last ``up``) run on ``conv3x3_cat`` (K3 for a CUDA tensor) with
BatchNorm folded at ``freeze()``; the mid-resolution stages stay
``F.conv2d``.

``forward(epses, training=True)`` is the trainer's form,
``srflow_unet_apply(..., training=True)``: plain convs (cuDNN on the card,
as XLA convs in JAX), every BatchNorm normalising with its batch's
statistics, which it returns beside the output, keyed by the BatchNorm's
``state_dict`` name; ``apply_bn_updates`` folds them into the running
stats (``models/unet.py``).

``state_dict`` keys are the reference's: ``input_proj{b}``, ``inc{b}``,
``down_layers{b}.{i}.maxpool_conv.1``, ``up_layers{b}.{i}.conv``,
``outc{b}.conv``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.unet import (DenseBlock5C, DoubleConv, Down,
                                        OutConv, UNet, Up, _upsample_to)
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.registry import register


@register("srflow-unet")
class SRFlowUNet(Model):
    registry_name = "srflow-unet"

    def __init__(self, depth=3, dim=64, bilinear=True, ch0=6, ch1=96):
        super().__init__()
        if not bilinear:
            raise NotImplementedError("transposed-conv Up is not used by the "
                                      "shipped configs")
        self.args = dict(depth=depth, dim=dim, bilinear=bilinear, ch0=ch0,
                         ch1=ch1)
        self.depth = depth
        for b, ch in ((0, ch0), (1, ch1)):
            setattr(self, f"input_proj{b}", DenseBlock5C(ch, dim, dim))
            setattr(self, f"inc{b}", DoubleConv(dim, dim))
            downs = []
            for i in range(depth):
                cout = dim * 2 ** (i + 1)
                if i == depth - 1:
                    cout //= 2
                downs.append(Down(dim * 2 ** i, cout))
            setattr(self, f"down_layers{b}", nn.ModuleList(downs))
            ups = []
            for i in range(depth):
                cin = dim * 2 ** (depth - i)
                cout = dim * 2 ** (depth - i - 1)
                if i < depth - 1:
                    cout //= 2
                ups.append(Up(cin, cout, cin // 2))
            setattr(self, f"up_layers{b}", nn.ModuleList(ups))
            setattr(self, f"outc{b}", OutConv(dim, ch))
        self.reset_parameters(seeded(0))

    def branch(self, b):
        """(input_proj, inc, downs, ups, outc) of branch ``b``."""
        return tuple(getattr(self, f"{n}{b}") for n in
                     ("input_proj", "inc", "down_layers", "up_layers", "outc"))

    def reset_parameters(self, generator):
        """``_init_branch``'s distributions: dense blocks kaiming-normal
        (fan_in) x 0.1, other convs torch-default, BN identity."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, DenseBlock5C):
                for c in m.convs():
                    fnn.init_conv_(c, generator, "kaiming_normal_fan_in", 0.1)

    @torch.no_grad()
    def freeze(self):
        """Cache what the K3 stages take (see the module docstring)."""
        for b in (0, 1):
            proj, inc, _, ups, _ = self.branch(b)
            proj.freeze()
            inc.freeze()
            ups[-1].conv.freeze()
        cuda.stamp_layouts(self)
        return self

    def _branch(self, b, z, kernels, bn_stats=None):
        proj, inc, downs, ups, outc = self.branch(b)
        if kernels:
            x = inc.forward_cat([proj.forward_cat([z])])
        else:
            x = inc(proj(z), bn_stats)
        feats = [x]
        for down in downs:
            x = down(x, bn_stats)
            feats.append(x)
        last = len(ups) - 1
        for i, up in enumerate(ups):
            skip = feats[self.depth - 1 - i]
            if kernels and i == last:
                x = up.conv.forward_cat([skip, _upsample_to(x, skip.shape[1:3])])
            else:
                x = up(x, skip, bn_stats)
        return fnn.conv2d(x, outc.conv.weight, outc.conv.bias)

    def forward(self, epses, kernels=True, training=False):
        """[eps0 (B, h0, w0, ch0), z (B, h1, w1, ch1)] -> the learned pair;
        with ``training=True`` (plain convs, batch statistics) ``(pair,
        bn_stats)``, bn_stats mapping each BatchNorm's ``state_dict`` name
        to its batch's (mean, unbiased var)."""
        if training:
            stats = {}
            out = [self._branch(b, epses[b], False, stats) for b in (0, 1)]
            names = {m: n for n, m in self.named_modules()}
            return out, {names[m]: v for m, v in stats.items()}
        if kernels:
            cuda.check_layouts(self)
        return [self._branch(0, epses[0], kernels),
                self._branch(1, epses[1], kernels)]

    apply_bn_updates = UNet.apply_bn_updates
