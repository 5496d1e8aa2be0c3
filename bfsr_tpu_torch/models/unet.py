"""UNet latent (prior) module: eval mode, and the trainer's batch-stat
mode.

The counterpart of ``bfsr_tpu/models/unet.py``: a DenseBlock_5C input
projection of the latent z plus a stride-3 LR projection (conv + lrelu +
DenseBlock_5C, resized to z's grid) -> concat -> depth-d UNet (maxpool
down / bilinear align_corners up + skip concat, DoubleConv =
[conv3x3 -> BN -> lrelu] x 2) -> 1x1 out conv.  NHWC in and out.

``forward(z, lr, kernels=True)`` follows ``unet_apply_fused``: the
full-resolution stages — the dense input projection, ``inc`` and the last
``up`` — run on ``conv3x3_cat`` (the K3 kernel for a CUDA tensor) over
implicit channel concats, with BatchNorm folded into the epilogue; the
mid-resolution stages and the LR projection stay ``F.conv2d``.
``kernels=False`` follows ``unet_apply``: plain convs, explicit concats,
unfolded BatchNorm, on any device.  Both paths follow the stage's
precision (the ``prior`` stage of the predictors): in a bf16 stage the 9
full-resolution convs run the bf16 K3 and every other conv takes bf16
operands.  ``freeze()`` keeps what the K3 stages take: their conv weights
in K3's layouts and their BatchNorm folded; call it again after changing
the weights.

``forward(z, lr, training=True)`` is the trainer's form, ``unet_apply(...,
training=True)``: plain convs (cuDNN on the card, as XLA convs in JAX),
every BatchNorm normalising with its batch's statistics, which it returns
beside the output, keyed by the BatchNorm's ``state_dict`` name;
``apply_bn_updates`` folds them into the running stats.

``state_dict`` keys are the reference's (``input_proj.conv{1..5}``,
``lr_proj.{0,2}``, ``inc.double_conv.{0,1,3,4}``,
``down_layers.{i}.maxpool_conv.1.*``, ``up_layers.{i}.conv.*``,
``outc.conv``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops.cuda.conv3x3 import (cache_kernel_weight, conv3x3_cat,
                                             conv3x3_cat_twin, k3_conv)
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.registry import register


def k3(blocks, conv, act):
    """``conv3x3_cat`` (K3) of the conv module ``conv`` over the implicit
    concat ``blocks``: its bias, the activation ``act`` in the epilogue,
    its frozen weight layouts."""
    return conv3x3_cat(blocks, conv.weight, bias=conv.bias, act=act,
                       kweight=conv.kweight, kweight_bf16=conv.kweight_bf16)


def k3_twin(blocks, conv, act):
    """``k3`` on K3's plain twin of the stage's precision, on any
    device."""
    return conv3x3_cat_twin(blocks, conv.weight, bias=conv.bias, act=act)


class DenseBlock5C(nn.Module):
    def __init__(self, nf, gc, out_dim):
        super().__init__()
        cins = [nf + i * gc for i in range(5)]
        couts = [gc] * 4 + [out_dim]
        for i in range(5):
            setattr(self, f"conv{i + 1}", k3_conv(cins[i], couts[i]))

    def convs(self):
        return [getattr(self, f"conv{i + 1}") for i in range(5)]

    def forward(self, x):
        """Reference order: 5 convs over growing explicit concats."""
        feats = [x]
        for i, c in enumerate(self.convs()):
            y = fnn.conv2d(torch.cat(feats, -1), c.weight, c.bias)
            feats.append(fnn.leaky_relu(y) if i < 4 else y)
        return feats[-1]

    def forward_cat(self, blocks, conv=k3):
        """Over an implicit concat of ``blocks``, each conv through
        ``conv(blocks, module, act)`` (``k3``: K3)."""
        blocks = list(blocks)
        for i, c in enumerate(self.convs()):
            blocks.append(conv(blocks, c, "lrelu" if i < 4 else None))
        return blocks[-1]

    def freeze(self):
        for c in self.convs():
            cache_kernel_weight(c)


def _bn_lrelu(h, bn, bn_stats):
    """lrelu(BatchNorm(h)): eval mode, or with a dict ``bn_stats`` the
    batch's statistics, recorded there under ``bn``."""
    if bn_stats is None:
        return fnn.leaky_relu(fnn.batch_norm(h, bn))
    h, bn_stats[bn] = fnn.batch_norm(h, bn, training=True)
    return fnn.leaky_relu(h)


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            k3_conv(cin, mid, bias=False), nn.BatchNorm2d(mid),
            nn.LeakyReLU(0.2, True), k3_conv(mid, cout, bias=False),
            nn.BatchNorm2d(cout), nn.LeakyReLU(0.2, True))
        # each BatchNorm folded to a (2, C) stack of (scale, bias), by freeze()
        self.register_buffer("folded1", None, persistent=False)
        self.register_buffer("folded2", None, persistent=False)

    def forward(self, x, bn_stats=None):
        """Reference order.  With a dict ``bn_stats``, each BatchNorm takes
        its batch's statistics and records them there, keyed by the
        BatchNorm module."""
        dc = self.double_conv
        h = _bn_lrelu(fnn.conv2d(x, dc[0].weight), dc[1], bn_stats)
        return _bn_lrelu(fnn.conv2d(h, dc[3].weight), dc[4], bn_stats)

    def _fold(self):
        dc = self.double_conv
        return torch.stack(fnn.fold_bn(dc[1])), torch.stack(fnn.fold_bn(dc[4]))

    def freeze(self):
        cache_kernel_weight(self.double_conv[0])
        cache_kernel_weight(self.double_conv[3])
        self.folded1, self.folded2 = self._fold()

    def forward_cat(self, blocks):
        """Eval DoubleConv over an implicit concat, BN folded, on K3."""
        dc = self.double_conv
        f1, f2 = ((self.folded1, self.folded2) if self.folded1 is not None
                  else self._fold())
        h = conv3x3_cat(blocks, dc[0].weight, scale=f1[0], bias=f1[1],
                        act="lrelu", kweight=dc[0].kweight,
                        kweight_bf16=dc[0].kweight_bf16)
        return conv3x3_cat([h], dc[3].weight, scale=f2[0], bias=f2[1],
                           act="lrelu", kweight=dc[3].kweight,
                           kweight_bf16=dc[3].kweight_bf16)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x, bn_stats=None):
        return self.maxpool_conv[1](fnn.max_pool2d(x, 2), bn_stats)


def _upsample_to(x1, hw):
    """Bilinear x2 (align_corners) then zero-pad to ``hw``, centered."""
    x1 = resize_bilinear(x1, (x1.shape[1] * 2, x1.shape[2] * 2),
                         align_corners=True)
    dh, dw = hw[0] - x1.shape[1], hw[1] - x1.shape[2]
    return F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class Up(nn.Module):
    def __init__(self, cin, cout, mid):
        super().__init__()
        self.conv = DoubleConv(cin, cout, mid)

    def forward(self, x1, x2, bn_stats=None):
        return self.conv(torch.cat([x2, _upsample_to(x1, x2.shape[1:3])], -1),
                         bn_stats)


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


@register("unet")
class UNet(Model):
    registry_name = "unet"

    def __init__(self, in_chans, depth=3, dim=64, bilinear=True):
        super().__init__()
        if not bilinear:
            raise NotImplementedError("transposed-conv Up is not used by the "
                                      "shipped configs")
        self.args = dict(in_chans=in_chans, depth=depth, dim=dim,
                         bilinear=bilinear)
        self.in_chans, self.depth, self.dim = in_chans, depth, dim
        self.input_proj = DenseBlock5C(in_chans, dim // 2, dim // 2)
        self.lr_proj = nn.Sequential(
            nn.Conv2d(3, in_chans, 3, stride=3, padding=1),
            nn.LeakyReLU(0.2, True), DenseBlock5C(in_chans, dim // 2, dim // 2))
        self.inc = DoubleConv(dim, dim)
        self.down_layers = nn.ModuleList()
        for i in range(depth):
            cout = dim * 2 ** (i + 1)
            if i == depth - 1:
                cout //= 2
            self.down_layers.append(Down(dim * 2 ** i, cout))
        self.up_layers = nn.ModuleList()
        for i in range(depth):
            cin = dim * 2 ** (depth - i)
            cout = dim * 2 ** (depth - i - 1)
            if i < depth - 1:
                cout //= 2
            self.up_layers.append(Up(cin, cout, cin // 2))
        self.outc = OutConv(dim, in_chans)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        """The init of ``bfsr_tpu/models/unet.py:init_unet``: dense blocks
        kaiming-normal(fan_in) x 0.1, other convs torch-default, BN
        identity."""
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
        self.input_proj.freeze()
        self.inc.freeze()
        self.up_layers[-1].conv.freeze()
        cuda.stamp_layouts(self)
        return self

    def _lr_embed(self, lr, hw):
        c = self.lr_proj[0]
        e = fnn.leaky_relu(fnn.conv2d(lr, c.weight, c.bias, stride=3,
                                      padding=1))
        e = self.lr_proj[2](e)
        if e.shape[1:3] != tuple(hw):
            e = resize_bilinear(e, hw, align_corners=False)
        return e

    def _out(self, x):
        return fnn.conv2d(x, self.outc.conv.weight, self.outc.conv.bias)

    def forward(self, z, lr, kernels=True, training=False):
        """z: (B, H, W, in_chans) latent; lr: (B, h, w, 3) normalized LR.
        Returns (B, H, W, in_chans); with ``training=True`` (plain convs,
        batch statistics, any batch) ``(out, bn_stats)``, bn_stats mapping
        each BatchNorm's ``state_dict`` name to its batch's (mean, unbiased
        var)."""
        if training:
            stats = {}
            out = self._forward_plain(z, lr, stats)
            names = {m: n for n, m in self.named_modules()}
            return out, {names[m]: v for m, v in stats.items()}
        if not kernels:
            return self._forward_plain(z, lr)
        cuda.check_layouts(self)
        hw = z.shape[1:3]
        proj = self.input_proj.forward_cat([z])
        x = self.inc.forward_cat([proj, self._lr_embed(lr, hw)])
        feats = [x]
        for down in self.down_layers:
            x = down(x)
            feats.append(x)
        for i, up in enumerate(self.up_layers[:-1]):
            x = up(x, feats[self.depth - 1 - i])
        x = self.up_layers[-1].conv.forward_cat(
            [feats[0], _upsample_to(x, hw)])
        return self._out(x)

    def _forward_plain(self, z, lr, bn_stats=None):
        x = self.input_proj(z)
        x = torch.cat([x, self._lr_embed(lr, x.shape[1:3])], -1)
        x = self.inc(x, bn_stats)
        feats = [x]
        for down in self.down_layers:
            x = down(x, bn_stats)
            feats.append(x)
        for i, up in enumerate(self.up_layers):
            x = up(x, feats[self.depth - 1 - i], bn_stats)
        return self._out(x)

    @torch.no_grad()
    def apply_bn_updates(self, bn_stats, momentum=0.1):
        """Fold the batch statistics of ``forward(..., training=True)`` into
        the running stats, torch's update at ``momentum``:
        ``bfsr_tpu/models/unet.py:apply_bn_updates``."""
        for name, (mean, var) in bn_stats.items():
            bn = self.get_submodule(name)
            bn.running_mean.mul_(1 - momentum).add_(momentum * mean.detach())
            bn.running_var.mul_(1 - momentum).add_(momentum * var.detach())
            bn.num_batches_tracked += 1
