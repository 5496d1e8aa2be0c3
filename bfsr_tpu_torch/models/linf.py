"""LINF: Local Implicit Normalizing Flow, pixel ('linf') and patch
('linf-patch') models.

The counterpart of ``bfsr_tpu/models/linf.py`` for regular query grids
(every ``make_coord`` grid the eval path uses, and the patch-centre grids
of the patch wrappers):

1. ``gen_feat`` — EDSR features over the LR image (K3 on CUDA).
2. ``head`` — the coef/freq 3x3 convs (``F.conv2d``, TF32 off) and
   ``phase``, a bias-free linear of the relative cell; both follow the
   stage's precision (the ``head`` stage of the predictors).
3. ``affine_info_grid`` — 4-corner local ensemble, Fourier basis, area
   weights and the MLP, per query: the K2 kernel on CUDA
   (``ops/cuda/linf_info.py``), its plain twin otherwise.
4. The pointwise flow at d = 3 ps^2, forward (``query_log_p``) or inverse
   (``query_rgb``: K1 at d = 3, K4 at d = 27 on CUDA).  The pixel model
   adds the bilinear LR back; the patch model folds each query's d-vector
   into a ps x ps patch (``fold``, the JAX package's ``_fold``) and leaves
   the LR add-back to its caller, as the reference's test loop does.

``kernels=True`` runs each step's kernel wrapper (the kernel for a CUDA
tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the plain
twins on any device.

Batch 1 throughout.  ``state_dict`` keys are the reference's:
``encoder.*``, ``coef``, ``freq``, ``phase``, ``layers.{0,2,..}``,
``imnet.*``.
"""

import torch
from torch import nn

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.flow_linf import Flow
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.ops.cuda.linf_info import (affine_info, affine_info_plain,
                                               nearest_index, pack_mlp)
from bfsr_tpu_torch.ops.interp import grid_sample_bilinear_separable
from bfsr_tpu_torch.registry import register

# nearest_index: the closed-form nearest-LR-pixel lookup (round half to
# even), shared with the K2 twin
__all__ = ["LINF", "LINFPatch", "grid_axes", "nearest_index"]


def grid_axes(coord):
    """(coord_y (H,), coord_x (W,)) of a regular grid coord (1, H, W, 2)."""
    return coord[0, :, 0, 0].contiguous(), coord[0, 0, :, 1].contiguous()


class _LINFBase(Model):
    def __init__(self, encoder_spec, imnet_spec=None, flow_layers=10,
                 num_layer=3, hidden_dim=256, patch_size=1):
        super().__init__()
        self.args = dict(encoder_spec=encoder_spec, imnet_spec=imnet_spec,
                         flow_layers=flow_layers, num_layer=num_layer,
                         hidden_dim=hidden_dim)
        if patch_size != 1:
            self.args["patch_size"] = patch_size
        self.encoder = registry.make(encoder_spec)
        self.flow_layers = flow_layers
        self.hidden_dim = hidden_dim
        self.num_layer = num_layer
        self.patch_size = patch_size
        self.dim = 3 * patch_size * patch_size
        C = hidden_dim
        self.coef = nn.Conv2d(self.encoder.out_dim, C, 3, padding=1)
        self.freq = nn.Conv2d(self.encoder.out_dim, C, 3, padding=1)
        self.phase = nn.Linear(2, C // 2, bias=False)
        layers = [nn.Conv2d(4 * C, C, 1), nn.ReLU()]
        for _ in range(num_layer - 1):
            layers += [nn.Conv2d(C, C, 1), nn.ReLU()]
        layers.append(nn.Conv2d(C, flow_layers * self.dim * 2, 1))
        self.layers = nn.Sequential(*layers)
        self.imnet = Flow(flow_layers, patch_size)
        # the MLP in K2's packed layout, from freeze()
        self.register_buffer("mlp_packed", None, persistent=False)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        """The init of ``bfsr_tpu/models/linf.py:init_linf`` (torch-default
        distributions), from ``generator``."""
        self.encoder.reset_parameters(generator)
        for m in self.layers:
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)
        fnn.init_conv_(self.coef, generator)
        fnn.init_conv_(self.freq, generator)
        fnn.init_linear_(self.phase, generator)
        self.imnet.reset_parameters(generator)

    @torch.no_grad()
    def freeze(self):
        """Freeze the model (LINF-LP trains only the prior) and cache what
        the kernels take: the flow inverses, the MLP packed for K2, the
        encoder's conv weights in K3's layout.  Call it again after
        changing the weights."""
        self.requires_grad_(False)
        self.imnet.freeze()
        self.encoder.freeze()
        self.mlp_packed = pack_mlp(self.mlp())
        return self

    def mlp(self):
        """The info MLP as (weight (out, in), bias) pairs."""
        return [(m.weight[:, :, 0, 0], m.bias) for m in self.layers
                if isinstance(m, nn.Conv2d)]

    # -- pipeline pieces ----------------------------------------------------

    def gen_feat(self, inp, kernels=True):
        """inp: (1, h, w, 3) normalized LR -> features (1, h, w, C_enc)."""
        return self.encoder(inp, kernels=kernels)

    def head(self, feat):
        """coef, freq: (1, h, w, hidden) — the Fourier head's 3x3 convs."""
        return (fnn.conv2d(feat, self.coef.weight, self.coef.bias),
                fnn.conv2d(feat, self.freq.weight, self.freq.bias))

    def phase_of(self, cell, h, w):
        """(hidden/2,) phase of the relative cell; cell: (1, 2)."""
        rel_cell = cell * torch.tensor([h, w], dtype=cell.dtype,
                                       device=cell.device)
        return fnn.linear(rel_cell, self.phase.weight)[0]

    def affine_info_grid(self, feat, coord_y, coord_x, cell, kernels=True):
        """Channel-major info (2dL, H*W) for the grid coord_y x coord_x
        (each 1-D).  The K2 kernel (CUDA) or its twin."""
        coef, freq = self.head(feat)
        phase = self.phase_of(cell, feat.shape[1], feat.shape[2])
        if kernels:
            return affine_info(coef, freq, coord_y, coord_x, phase, self.mlp(),
                               self.mlp_packed)
        return affine_info_plain(coef, freq, coord_y, coord_x, phase,
                                 self.mlp())

    def query_log_p(self, inp, feat, coord, cell, gt, kernels=True):
        """gt: (1, H, W, d) residual -> (log_p (H*W,), z (1, H, W, d)) on
        the regular grid ``coord`` (1, H, W, 2).  The info comes from
        ``affine_info_grid``; the flow forward is the plain
        ``pointwise_flow.forward``, because log_p needs the log-determinants
        and K1 computes z only."""
        _, H, W, _ = coord.shape
        cy, cx = grid_axes(coord)
        info = self.affine_info_grid(feat, cy, cx, cell, kernels)
        z, log_p = self.imnet(gt.reshape(-1, self.dim), info.T)
        return log_p, z.reshape(1, H, W, self.dim)

    def query_rgb(self, inp, feat, coord, cell, temperature=0.0, zmap=None,
                  generator=None, info=None, kernels=True):
        """Flow inverse of ``zmap`` (1, H, W, d) — or of zeros, or of
        N(0, temperature^2) noise drawn from ``generator`` — then, for the
        pixel model, the bilinear LR add-back (1, H, W, 3); for the patch
        model, the folded residual (1, H*ps, W*ps, 3) with no add-back.
        ``info``: the grid's channel-major affine info if the caller has
        it, else it is computed from ``feat``."""
        _, H, W, _ = coord.shape
        cy, cx = grid_axes(coord)
        if info is None:
            info = self.affine_info_grid(feat, cy, cx, cell, kernels)
        n = H * W
        if zmap is not None:
            z = zmap.reshape(n, self.dim).contiguous()
        elif temperature:
            z = torch.randn((n, self.dim), generator=generator,
                            device=inp.device) * temperature
        else:
            z = torch.zeros((n, self.dim), device=inp.device)
        inv = linf_flow.flow_inverse if kernels else linf_flow.flow_inverse_plain
        pred = inv(self.imnet.w_inv, self.imnet.b, z, info)
        pred = pred.reshape(1, H, W, self.dim)
        if self.patch_size != 1:
            return self.fold(pred)
        return pred + grid_sample_bilinear_separable(inp, cy, cx)

    def fold(self, pred):
        """(1, Hq, Wq, 3 ps^2) -> (1, Hq ps, Wq ps, 3), each query's vector
        read in torch ``F.fold``'s (c, ky, kx) channel order."""
        ps = self.patch_size
        B, Hq, Wq, _ = pred.shape
        x = pred.reshape(B, Hq, Wq, 3, ps, ps).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(B, Hq * ps, Wq * ps, 3)


@register("linf")
class LINF(_LINFBase):
    registry_name = "linf"

    def __init__(self, encoder_spec, imnet_spec=None, flow_layers=10,
                 num_layer=3, hidden_dim=256):
        super().__init__(encoder_spec, imnet_spec, flow_layers, num_layer,
                         hidden_dim, 1)


@register("linf-patch")
class LINFPatch(_LINFBase):
    registry_name = "linf-patch"

    def __init__(self, encoder_spec, imnet_spec=None, flow_layers=10,
                 num_layer=3, hidden_dim=256, patch_size=3):
        super().__init__(encoder_spec, imnet_spec, flow_layers, num_layer,
                         hidden_dim, patch_size)

