"""RRDBNet (the ESRGAN trunk): SRFlow's conditioning network and the
plain-SR generator, registered as ``'rrdb'``.

The counterpart of ``bfsr_tpu/models/rrdb.py`` in its plain NHWC form
(``init_rrdb``, ``_dense_block``, ``rrdb_apply_steps``, ``RRDBNet``):
conv_first -> nb RRDBs (3 residual dense blocks each, residual scale
0.2) -> trunk_conv + skip (``encode``).  ``steps`` adds the taps SRFlow's
flow levels read: nearest-up x2 through upconv1 and a bilinear
down-resize to half size (the x4 head's ``fea_up4`` / ``out``, which the
flow never reads, are not computed).  ``forward`` is the registry model's
``apply``: with ``no_upsampling=True`` the trunk features, else the x4
generator: nearest x2 -> upconv1 -> lrelu -> nearest x4 -> upconv2 ->
lrelu -> HRconv -> lrelu -> conv_last.  The TPU layouts of the trunk
(batch-to-space, scatter, space-to-depth) and its remat are not ported:
they compute the same sums.

``kernels=True`` runs every dense-block conv on ``conv3x3_cat`` (the K3
kernel for a CUDA tensor) over the block's implicit concat, as
``rrdb._dense_block_s2d`` runs them on the TPU kernel, with the LeakyReLU
of conv1-4 in the kernel's epilogue, on the layouts ``freeze()`` keeps
(checked against the weights once a pass: ``ops/cuda.check_layouts``);
``kernels=TWINS`` (``ops/cuda``) the same on K3's plain twin, on any
device; ``conv(blocks, module, act)``, if given, in place of either (a
harness that holds each launch against its twin); ``kernels=False`` runs
the reference order with explicit concats through ``fnn.conv2d``: the
path autograd differentiates (K3 has no backward), which a trainer of
the RRDB takes.  The other convs (conv_first, trunk_conv and the head)
stay ``fnn.conv2d``.

``state_dict`` keys are the reference's: ``conv_first``,
``RRDB_trunk.{i}.RDB{1,2,3}.conv{1..5}``, ``trunk_conv``, and with the
head ``upconv1``, ``upconv2``, ``HRconv``, ``conv_last``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.unet import DenseBlock5C, k3, k3_twin
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import TWINS, check_layouts, stamp_layouts
from bfsr_tpu_torch.ops.interp import resize_bilinear, resize_nearest
from bfsr_tpu_torch.registry import register


class RRDB(nn.Module):
    def __init__(self, nf, gc):
        super().__init__()
        self.RDB1 = DenseBlock5C(nf, gc, nf)
        self.RDB2 = DenseBlock5C(nf, gc, nf)
        self.RDB3 = DenseBlock5C(nf, gc, nf)

    def forward(self, x, kernels=True, conv=None):
        out = x
        conv = conv or (k3_twin if kernels == TWINS else k3)
        for rdb in (self.RDB1, self.RDB2, self.RDB3):
            y = rdb.forward_cat([out], conv) if kernels else rdb(out)
            out = y * 0.2 + out
        return out * 0.2 + x


def _conv(x, conv):
    return fnn.conv2d(x, conv.weight, conv.bias)


@register("rrdb")
class RRDBNet(Model):
    registry_name = "rrdb"

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=23, gc=32,
                 no_upsampling=True):
        super().__init__()
        self.args = dict(in_nc=in_nc, out_nc=out_nc, nf=nf, nb=nb, gc=gc,
                         no_upsampling=no_upsampling)
        self.no_upsampling = no_upsampling
        self.out_dim = nf if no_upsampling else out_nc
        self.conv_first = nn.Conv2d(in_nc, nf, 3, padding=1)
        self.RRDB_trunk = nn.ModuleList([RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = nn.Conv2d(nf, nf, 3, padding=1)
        if not no_upsampling:
            self.upconv1 = nn.Conv2d(nf, nf, 3, padding=1)
            self.upconv2 = nn.Conv2d(nf, nf, 3, padding=1)
            self.HRconv = nn.Conv2d(nf, nf, 3, padding=1)
            self.conv_last = nn.Conv2d(nf, out_nc, 3, padding=1)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        """``init_rrdb``'s distributions: dense-block convs xavier-normal
        x 0.1 with zero bias, the other convs torch's default."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)
        for blk in self.RRDB_trunk:
            for rdb in (blk.RDB1, blk.RDB2, blk.RDB3):
                for c in rdb.convs():
                    fnn.init_conv_(c, generator, "xavier_normal", 0.1)

    @torch.no_grad()
    def freeze(self):
        for blk in self.RRDB_trunk:
            for rdb in (blk.RDB1, blk.RDB2, blk.RDB3):
                rdb.freeze()
        stamp_layouts(self)
        return self

    def _trunk(self, x, block_idxs=(), kernels=True, conv=None):
        """(fea + trunk_conv(trunk(fea)), {block_{i}: the taps})."""
        if kernels and kernels != TWINS:
            check_layouts(self)
        fea = _conv(x, self.conv_first)
        res = {}
        t = fea
        for idx, blk in enumerate(self.RRDB_trunk):
            t = blk(t, kernels, conv)
            if idx in block_idxs:
                res[f"block_{idx}"] = t
        return fea + _conv(t, self.trunk_conv), res

    def encode(self, x, kernels=True, conv=None):
        """``rrdb_encode``: the trunk features (B, h, w, nf)."""
        return self._trunk(x, (), kernels, conv)[0]

    def steps(self, x, block_idxs=(), kernels=True, conv=None):
        """``rrdb_apply_steps`` for the maps SRFlow's conditioning reads:
        x (B, h, w, 3) -> dict of ``block_{i}`` taps, ``fea_up1`` (the trunk
        output), ``fea_up2`` (upconv1 of its nearest-up x2) and ``fea_up0``
        (its bilinear down-resize to h/2).  The x4 head (``fea_up4``,
        HRconv, conv_last) is not computed: the flow does not read it."""
        last, res = self._trunk(x, block_idxs, kernels, conv)
        h, w = x.shape[1], x.shape[2]
        res["fea_up1"] = last
        res["fea_up2"] = _conv(resize_nearest(last, (h * 2, w * 2)),
                               self.upconv1)
        res["fea_up0"] = resize_bilinear(last, (h // 2, w // 2))
        return res

    def forward(self, x, kernels=True):
        """``RRDBNet.apply``: the trunk features, or with the head the x4
        image (B, 4h, 4w, out_nc)."""
        fea = self.encode(x, kernels)
        if self.no_upsampling:
            return fea
        h, w = x.shape[1], x.shape[2]
        lrelu = fnn.leaky_relu
        f = lrelu(_conv(resize_nearest(fea, (h * 2, w * 2)), self.upconv1))
        f = lrelu(_conv(resize_nearest(f, (h * 4, w * 4)), self.upconv2))
        return _conv(lrelu(_conv(f, self.HRconv)), self.conv_last)
