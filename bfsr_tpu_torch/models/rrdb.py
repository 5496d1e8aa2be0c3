"""RRDBNet (the ESRGAN trunk): SRFlow's conditioning network and the
plain-SR generator, registered as ``'rrdb'``.

The counterpart of ``bfsr_tpu/models/rrdb.py`` in its plain NHWC form
(``init_rrdb``, ``_dense_block``, ``rrdb_apply_steps``, ``RRDBNet``):
conv_first -> nb RRDBs (3 residual dense blocks each, residual scale
0.2) -> trunk_conv + skip (``encode``).  ``steps`` adds the maps SRFlow's
flow levels read, and only those: nearest-up x2 through upconv1
(``fea_up2``), then nearest-up x4 of its LeakyReLU through upconv2
(``fea_up4``, read at x8 and x16), nearest-up x8 of that one's LeakyReLU
through upconv3 (``fea_up8``, read at x16; ``fea_up16`` through upconv4
likewise), and the bilinear down-resizes to h/2 (``fea_up0``) and h/4
(``fea_up-1``); a map past the deepest one asked for, and the image head
(``out``), are not computed.  ``forward`` is
the registry model's ``apply``: with ``no_upsampling=True`` the trunk
features, else the generator at ``scale`` 4, 8 or 16: nearest x2 ->
upconv1 -> lrelu -> nearest x4 -> upconv2 -> lrelu [-> nearest x8 ->
upconv3 -> lrelu [-> nearest x16 -> upconv4 -> lrelu]] -> HRconv -> lrelu
-> conv_last (``bfsr_tpu/models/rrdb.py:rrdb_apply_steps``).  The TPU
layouts of the trunk (batch-to-space, scatter, space-to-depth) and its
remat are not ported: they compute the same sums.

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
head ``upconv1``, ``upconv2``, from x8 ``upconv3``, at x16 ``upconv4``,
``HRconv``, ``conv_last``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.unet import DenseBlock5C, k3, k3_twin
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import TWINS, check_layouts, stamp_layouts
from bfsr_tpu_torch.ops.interp import resize_bilinear, resize_nearest
from bfsr_tpu_torch.registry import register

HEAD_SCALES = (4, 8, 16)
# the head's upsampled maps, upconv1-4's outputs in turn
UP_MAPS = ("fea_up2", "fea_up4", "fea_up8", "fea_up16")
# the maps ``steps`` computes besides the block taps
STEP_MAPS = ("fea_up1", *UP_MAPS, "fea_up0", "fea_up-1")


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
                 no_upsampling=True, scale=4):
        super().__init__()
        if scale not in HEAD_SCALES:
            raise ValueError(f"the RRDB's head upsamples x{HEAD_SCALES}, "
                             f"got x{scale}")
        self.args = dict(in_nc=in_nc, out_nc=out_nc, nf=nf, nb=nb, gc=gc,
                         no_upsampling=no_upsampling, scale=scale)
        self.no_upsampling = no_upsampling
        self.scale = scale
        self.out_dim = nf if no_upsampling else out_nc
        self.conv_first = nn.Conv2d(in_nc, nf, 3, padding=1)
        self.RRDB_trunk = nn.ModuleList([RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = nn.Conv2d(nf, nf, 3, padding=1)
        if not no_upsampling:
            self.upconv1 = nn.Conv2d(nf, nf, 3, padding=1)
            self.upconv2 = nn.Conv2d(nf, nf, 3, padding=1)
            if scale >= 8:
                self.upconv3 = nn.Conv2d(nf, nf, 3, padding=1)
            if scale >= 16:
                self.upconv4 = nn.Conv2d(nf, nf, 3, padding=1)
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

    def _ups(self):
        """The head's upconvs, x2 each: upconv1 ... upconv{log2 scale}."""
        return [getattr(self, f"upconv{i}")
                for i in range(1, self.scale.bit_length())]

    def steps(self, x, keys, block_idxs=(), kernels=True, conv=None):
        """``rrdb_apply_steps`` for the maps ``keys`` (of ``STEP_MAPS``)
        that SRFlow's conditioning reads: x (B, h, w, 3) -> dict of
        ``block_{i}`` taps and those maps: ``fea_up1`` (the trunk output),
        ``fea_up2`` (upconv1 of its nearest-up x2), ``fea_up4`` (upconv2 of
        the nearest-up x4 of lrelu(``fea_up2``)), ``fea_up8`` / ``fea_up16``
        (upconv3 / upconv4 of the nearest-up x8 / x16 of the one before's
        LeakyReLU), ``fea_up0`` / ``fea_up-1`` (its bilinear down-resizes
        to h/2 / h/4).  A map no key needs is not computed."""
        bad = set(keys) - set(STEP_MAPS)
        if bad:
            raise ValueError(f"RRDB steps computes {STEP_MAPS}, not "
                             f"{sorted(bad)}")
        last, res = self._trunk(x, block_idxs, kernels, conv)
        h, w = x.shape[1], x.shape[2]
        if "fea_up1" in keys:
            res["fea_up1"] = last
        depth = max((i + 1 for i, k in enumerate(UP_MAPS) if k in keys),
                    default=0)
        f = last
        for i, up in enumerate(self._ups()[:depth]):
            f = _conv(resize_nearest(fnn.leaky_relu(f) if i else f,
                                     (h << (i + 1), w << (i + 1))), up)
            if UP_MAPS[i] in keys:
                res[UP_MAPS[i]] = f
        for key, div in (("fea_up0", 2), ("fea_up-1", 4)):
            if key in keys:
                if w % div and fnn.width_shard():
                    raise ValueError(f"width_sharded: {key} of a strip of "
                                     f"width {w} is not its own columns")
                res[key] = resize_bilinear(last, (h // div, w // div))
        return res

    def forward(self, x, kernels=True, conv=None):
        """``RRDBNet.apply``: the trunk features, or with the head the
        image (B, s h, s w, out_nc) at ``scale`` s.  As LINF's encoder
        (``no_upsampling``) it is ``rrdb_encode``: its 345 dense-block convs
        on K3 at the input's batch."""
        fea = self.encode(x, kernels, conv)
        if self.no_upsampling:
            return fea
        h, w = x.shape[1], x.shape[2]
        lrelu = fnn.leaky_relu
        f = fea
        for i, up in enumerate(self._ups()):
            f = lrelu(_conv(resize_nearest(f, (h << (i + 1), w << (i + 1))),
                            up))
        return _conv(lrelu(_conv(f, self.HRconv)), self.conv_last)
