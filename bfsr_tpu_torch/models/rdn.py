"""RDN encoder (Residual Dense Network, ``rdn``): the counterpart of
``bfsr_tpu/models/rdn.py`` (the reference's ``LINF-LP/models/rdn.py``).

Config A: 20 blocks x 6 conv layers, growth 32; config B: 16 x 8, growth
64.  Shallow features (two convs) -> D residual dense blocks (each layer
a conv + ReLU over the concat of everything before it in the block, a
1x1 local fusion and a residual) -> a global 1x1 + 3x3 fusion plus the
first shallow feature.  ``no_upsampling`` gives the G0-channel features
for LINF; otherwise the reference's pixel-shuffle ``UPNet`` (scale 2, 3
or 4) gives RGB.  NHWC in and out.

A dense layer reads up to 9 inputs, past K3's 5, so every conv runs
``fnn.conv2d`` with explicit concats, as the JAX package runs XLA convs;
all follow the stage's precision.

``state_dict`` keys are the reference's: ``SFENet1``, ``SFENet2``,
``RDBs.{i}.convs.{j}.conv.0``, ``RDBs.{i}.LFF``, ``GFF.{0,1}``,
``UPNet.{0,2[,4]}``.
"""

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.registry import register

CONFIGS = {"A": (20, 6, 32), "B": (16, 8, 64)}


class _RDBConv(nn.Module):
    def __init__(self, cin, g, k):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, g, k, padding=k // 2),
                                  nn.ReLU())


class _RDB(nn.Module):
    def __init__(self, g0, g, c, k):
        super().__init__()
        self.convs = nn.Sequential(*[_RDBConv(g0 + i * g, g, k)
                                     for i in range(c)])
        self.LFF = nn.Conv2d(g0 + c * g, g0, 1)


def _conv(x, m):
    return fnn.conv2d(x, m.weight, m.bias)


@register("rdn")
class RDN(Model):
    registry_name = "rdn"

    def __init__(self, G0=64, RDNkSize=3, RDNconfig="B", scale=2,
                 no_upsampling=False):
        super().__init__()
        self.args = dict(G0=G0, RDNkSize=RDNkSize, RDNconfig=RDNconfig,
                         scale=scale, no_upsampling=no_upsampling)
        d, c, g = CONFIGS[RDNconfig]
        k = RDNkSize
        self.no_upsampling = no_upsampling
        self.out_dim = G0 if no_upsampling else 3
        self.SFENet1 = nn.Conv2d(3, G0, k, padding=k // 2)
        self.SFENet2 = nn.Conv2d(G0, G0, k, padding=k // 2)
        self.RDBs = nn.ModuleList([_RDB(G0, g, c, k) for _ in range(d)])
        self.GFF = nn.Sequential(nn.Conv2d(d * G0, G0, 1),
                                 nn.Conv2d(G0, G0, k, padding=k // 2))
        if not no_upsampling:
            if scale in (2, 3):
                up = [nn.Conv2d(G0, g * scale * scale, k, padding=k // 2),
                      nn.PixelShuffle(scale),
                      nn.Conv2d(g, 3, k, padding=k // 2)]
            elif scale == 4:
                up = [nn.Conv2d(G0, g * 4, k, padding=k // 2),
                      nn.PixelShuffle(2),
                      nn.Conv2d(g, g * 4, k, padding=k // 2),
                      nn.PixelShuffle(2),
                      nn.Conv2d(g, 3, k, padding=k // 2)]
            else:
                raise ValueError("scale must be 2, 3 or 4")
            self.UPNet = nn.Sequential(*up)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)

    def freeze(self):
        """No kernel layouts to keep: every conv is ``fnn.conv2d``."""
        return self

    def forward(self, x, kernels=True):
        """x: (B, H, W, 3) -> (B, H, W, G0), or RGB (B, H s, W s, 3) with
        the upsampler.  ``kernels`` is accepted for the LINF encoder
        interface; no conv here has a kernel."""
        f1 = _conv(x, self.SFENet1)
        h = _conv(f1, self.SFENet2)
        outs = []
        for rdb in self.RDBs:
            inp = h
            for layer in rdb.convs:
                inp = torch.cat([inp, fnn.relu(_conv(inp, layer.conv[0]))],
                                -1)
            h = _conv(inp, rdb.LFF) + h
            outs.append(h)
        h = _conv(_conv(torch.cat(outs, -1), self.GFF[0]), self.GFF[1]) + f1
        if self.no_upsampling:
            return h
        for m in self.UPNet:
            h = (fnn.pixel_shuffle(h, m.upscale_factor)
                 if isinstance(m, nn.PixelShuffle) else _conv(h, m))
        return h
