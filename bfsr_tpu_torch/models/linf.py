"""LINF: Local Implicit Normalizing Flow, pixel ('linf') and patch
('linf-patch') models.

The counterpart of ``bfsr_tpu/models/linf.py``, for a batch of samples,
each with its own regular query grid (every ``make_coord`` grid the eval
path uses, the patch-centre grids of the patch wrappers, and the
trainer's per-sample crops of a scale's grid):

1. ``gen_feat`` — EDSR features over the LR image (K3 on CUDA).
2. ``head`` — the coef/freq 3x3 convs (``F.conv2d``, TF32 off) and
   ``phase``, a bias-free linear of the relative cell; both follow the
   stage's precision (the ``head`` stage of the predictors).
3. ``affine_info_grid`` — 4-corner local ensemble, Fourier basis, area
   weights and the MLP, per query: the K2 kernel on CUDA
   (``ops/cuda/linf_info.py``), its plain twin otherwise.
   ``linf_affine_info`` is the same function at any query set, by 2-D
   gathers in plain torch (``bfsr_tpu/models/linf.py:linf_affine_info``;
   the JAX package has no kernel for it): ``query_log_p_general`` encodes
   through it where the coords are not separable.
4. The pointwise flow at d = 3 ps^2, forward (``query_log_p``) or inverse
   (``query_rgb``: K1 at d = 3, K4 at d = 27 on CUDA).  The pixel model
   adds the bilinear LR back; the patch model folds each query's d-vector
   into a ps x ps patch (``fold``, the JAX package's ``_fold``) and leaves
   the LR add-back to its caller, as the reference's test loop does.

``kernels=True`` runs each step's kernel wrapper (the kernel for a CUDA
tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the plain
twins on any device.  ``query_rgb``'s flow inverse carries a gradient
with respect to the latent (``linf_flow.flow_inverse_diff`` on the kernel
path, autograd through the twin otherwise), which the trainer's loss
backs through into the prior.

Any batch (the predictors pass 1, the trainer 16); the info and the
flows take a batch's queries as one flat, sample-major set.
``state_dict`` keys are the reference's:
``encoder.*``, ``coef``, ``freq``, ``phase``, ``layers.{0,2,..}``,
``imnet.*``.
"""

import math

import torch
from torch import nn

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.flow_linf import Flow
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.ops.cuda.linf_info import (affine_info, affine_info_plain,
                                               nearest_index, pack_mlp)
from bfsr_tpu_torch.ops.interp import (grid_sample_bilinear,
                                       grid_sample_bilinear_separable)
from bfsr_tpu_torch.registry import register

# nearest_index: the closed-form nearest-LR-pixel lookup (round half to
# even), shared with the K2 twin
__all__ = ["LINF", "LINFPatch", "grid_axes", "linf_affine_info",
           "nearest_index"]


def grid_axes(coord):
    """(coord_y (B, H), coord_x (B, W)) of regular grids coord (B, H, W, 2):
    each sample's row and column coordinates."""
    return coord[:, :, 0, 0].contiguous(), coord[:, 0, :, 1].contiguous()


def linf_affine_info(coef, freq, phase, coord, mlp):
    """Per-query affine info at any query set, row-major (B, ..., out_dim):
    ``bfsr_tpu/models/linf.py:linf_affine_info`` in plain torch, each
    corner's coef and freq taken by a 2-D gather.

    coef, freq: (B, h, w, C) head outputs; phase: (B, C/2); coord:
    (B, ..., 2) in (h, w) order; mlp: (weight (out, in), bias) pairs."""
    B, h, w, C = coef.shape
    half = C // 2
    lead = coord.shape[:-1]
    cy = coord[..., 0].reshape(B, -1)
    cx = coord[..., 1].reshape(B, -1)
    ph = phase[:, None, :]
    pieces = []
    for vx in (-1, 1):
        for vy in (-1, 1):
            sy = torch.clamp(cy + vx / h + 1e-6, -1 + 1e-6, 1 - 1e-6)
            sx = torch.clamp(cx + vy / w + 1e-6, -1 + 1e-6, 1 - 1e-6)
            iy, ix = nearest_index(sy, h), nearest_index(sx, w)
            rel_y = (cy - (-1.0 + (2.0 * iy + 1.0) / h)) * h
            rel_x = (cx - (-1.0 + (2.0 * ix + 1.0) / w)) * w
            idx = (iy.long() * w + ix.long())[..., None].expand(-1, -1, C)
            coef_ = torch.gather(coef.reshape(B, h * w, C), 1, idx)
            freq_ = torch.gather(freq.reshape(B, h * w, C), 1, idx)
            f = (freq_[..., :half] * rel_y[..., None]
                 + freq_[..., half:] * rel_x[..., None]) + ph
            basis = torch.cat([torch.cos(math.pi * f),
                               torch.sin(math.pi * f)], -1)
            pieces.append((coef_, basis, torch.abs(rel_y * rel_x) + 1e-9))
    tot = pieces[0][2] + pieces[1][2] + pieces[2][2] + pieces[3][2]
    # diagonal-opposite area swap
    x = torch.cat([(pieces[3 - k][2] / tot)[..., None] * pieces[k][0]
                   * pieces[k][1] for k in range(4)], -1).reshape(-1, 4 * C)
    for i, (wl, bl) in enumerate(mlp):
        x = fnn.linear(x, wl, bl)
        if i < len(mlp) - 1:
            x = fnn.relu(x)
    return x.reshape(*lead, -1)


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
        """inp: (B, h, w, 3) normalized LR -> features (B, h, w, C_enc)."""
        return self.encoder(inp, kernels=kernels)

    def head(self, feat):
        """coef, freq: (B, h, w, hidden) — the Fourier head's 3x3 convs."""
        return (fnn.conv2d(feat, self.coef.weight, self.coef.bias),
                fnn.conv2d(feat, self.freq.weight, self.freq.bias))

    def phase_of(self, cell, h, w):
        """(B, hidden/2) phase of each sample's relative cell; cell: (B, 2)."""
        rel_cell = cell * torch.tensor([h, w], dtype=cell.dtype,
                                       device=cell.device)
        return fnn.linear(rel_cell, self.phase.weight)

    def linf_affine_info(self, feat, coord, cell):
        """Row-major info (B, ..., 2dL) at any query set coord (B, ..., 2):
        the module function ``linf_affine_info`` (plain torch)."""
        coef, freq = self.head(feat)
        phase = self.phase_of(cell, feat.shape[1], feat.shape[2])
        return linf_affine_info(coef, freq, phase, coord, self.mlp())

    def affine_info_grid(self, feat, coord_y, coord_x, cell, kernels=True):
        """Channel-major info (2dL, B*H*W) for each sample's grid
        coord_y[b] x coord_x[b] (axes (B, H) and (B, W)), sample-major.  The
        K2 kernel (CUDA) or its twin."""
        coef, freq = self.head(feat)
        phase = self.phase_of(cell, feat.shape[1], feat.shape[2])
        if kernels:
            return affine_info(coef, freq, coord_y, coord_x, phase, self.mlp(),
                               self.mlp_packed)
        return affine_info_plain(coef, freq, coord_y, coord_x, phase,
                                 self.mlp())

    def query_log_p(self, inp, feat, coord, cell, gt, kernels=True):
        """gt: (B, H, W, d) residual -> (log_p (B*H*W,), z (B, H, W, d)) on
        the regular grids ``coord`` (B, H, W, 2).  The info comes from
        ``affine_info_grid``; the flow forward is the plain
        ``pointwise_flow.forward``, because log_p needs the log-determinants
        and K1 computes z only."""
        B, H, W, _ = coord.shape
        cy, cx = grid_axes(coord)
        info = self.affine_info_grid(feat, cy, cx, cell, kernels)
        z, log_p = self.imnet(gt.reshape(-1, self.dim), info.T)
        return log_p, z.reshape(B, H, W, self.dim)

    def query_log_p_general(self, inp, feat, coord, cell, gt):
        """``query_log_p`` at any query set coord (B, ..., 2), through the
        2-D-gather ``linf_affine_info``: for coords that are not separable
        into per-sample grid axes.  gt: (B, ..., d)."""
        info = self.linf_affine_info(feat, coord, cell)
        lead = info.shape[:-1]
        z, log_p = self.imnet(gt.reshape(-1, self.dim),
                              info.reshape(-1, info.shape[-1]))
        return log_p, z.reshape(*lead, self.dim)

    def query_rgb(self, inp, feat, coord, cell, temperature=0.0, zmap=None,
                  generator=None, info=None, kernels=True, grid=True):
        """Flow inverse of ``zmap`` (B, H, W, d) — or of zeros, or of
        N(0, temperature^2) noise drawn from ``generator`` — then, for the
        pixel model, the bilinear LR add-back (B, H, W, 3); for the patch
        model, the folded residual (B, H*ps, W*ps, 3) with no add-back.
        ``info``: the queries' channel-major affine info if the caller has
        it, else it is computed from ``feat`` on the grids.  ``grid``:
        whether ``coord`` is each sample's regular grid; if not, ``info``
        is the caller's and the add-back samples the LR at each query's
        own coordinate.  The result carries a gradient with respect to
        ``zmap``."""
        B, H, W, _ = coord.shape
        if grid:
            cy, cx = grid_axes(coord)
            if info is None:
                info = self.affine_info_grid(feat, cy, cx, cell, kernels)
        n = B * H * W
        if zmap is not None:
            z = zmap.reshape(n, self.dim).contiguous()
        elif temperature:
            z = torch.randn((n, self.dim), generator=generator,
                            device=inp.device) * temperature
        else:
            z = torch.zeros((n, self.dim), device=inp.device)
        inv = (linf_flow.flow_inverse_diff if kernels
               else linf_flow.flow_inverse_plain)
        pred = inv(self.imnet.w_inv, self.imnet.b, z, info)
        pred = pred.reshape(B, H, W, self.dim)
        if self.patch_size != 1:
            return self.fold(pred)
        if grid:
            return pred + grid_sample_bilinear_separable(inp, cy, cx)
        return pred + grid_sample_bilinear(inp, coord, "border")

    def fold(self, pred):
        """(B, Hq, Wq, 3 ps^2) -> (B, Hq ps, Wq ps, 3), each query's vector
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

