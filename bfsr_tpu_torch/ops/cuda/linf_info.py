"""K2: LINF per-query affine info on a regular HR grid, fully fused.

Kernel: ``bfsr_tpu_torch/csrc/linf_info.cu``, which replaces
``bfsr_tpu/ops/pallas/linf_info.py:_kernel`` (``fused_affine_info_cm``).
Its twin is ``affine_info_plain``, the computation of
``bfsr_tpu/models/linf.py:linf_affine_info_grid`` over query-row chunks.

Inputs, for a batch of B samples, each with its own grid: coef, freq
(B, h, w, C) NHWC — the Fourier head's conv outputs; coord_y (B, H),
coord_x (B, W) — grid-center coordinates of each sample's HR rows and
columns; phase (B, C/2) — the phase linear of each sample's relative
cell; mlp — list of (weight (out, in), bias) pairs: 4C -> C, (C -> C) x
n_hidden, C -> out_dim (60 for the pixel model, 2dL = 540 for the d = 27
patch model).  Output: channel-major info (out_dim, B*H*W), sample-major
along the columns.  At B = 1 the axes may be 1-D, (H,) and (W,), and the
phase (C/2,), as the predictors pass them.
A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
The kernel reads the MLP as one buffer, ``pack_mlp(mlp)``; a frozen model
packs it once (``LINF.freeze``).
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn

KERNEL_HIDDEN = (128, 256)
KERNEL_MAX_OUT = 1024
KERNEL_MAX_BATCH = 65535  # the grid's y extent
CHUNK_QUERIES = 16384  # twin: queries per chunk (bounds the 4C features)


def nearest_index(coord, n):
    """Index of the LR pixel whose grid center is nearest to ``coord``
    along one axis: unnormalize, round half to even, clamp."""
    return torch.clamp(torch.round(((coord + 1.0) * n - 1.0) / 2.0), 0, n - 1)


def axis_hits(coord, shift, n):
    """(index, relative offset in LR pixels) of each coord after a shift."""
    s = torch.clamp(coord + shift + 1e-6, -1 + 1e-6, 1 - 1e-6)
    idx = nearest_index(s, n)
    q = -1.0 + (2.0 * idx + 1.0) / n
    return idx.long(), (coord - q) * n


def _batched(coord_y, coord_x, phase):
    """The axes as (B, H), (B, W) and the phase as (B, C/2): 1-D axes are
    batch 1."""
    if coord_y.ndim == 1:
        return coord_y[None], coord_x[None], phase.reshape(1, -1)
    return coord_y, coord_x, phase


def affine_info_plain(coef, freq, coord_y, coord_x, phase, mlp,
                      chunk_queries=CHUNK_QUERIES):
    """Plain twin of K2: per sample, gathers, cos/sin and matmuls over
    row chunks."""
    B, h, w, C = coef.shape
    coord_y, coord_x, phase = _batched(coord_y, coord_x, phase)
    H, W = coord_y.shape[1], coord_x.shape[1]
    out_dim = mlp[-1][0].shape[0]
    out = torch.empty((out_dim, B * H * W), dtype=coef.dtype,
                      device=coef.device)
    for b in range(B):
        _sample_info(coef[b], freq[b], coord_y[b], coord_x[b], phase[b], mlp,
                     chunk_queries, out[:, b * H * W:(b + 1) * H * W])
    return out


def _sample_info(coef, freq, coord_y, coord_x, phase, mlp, chunk_queries,
                 out):
    """One sample's info into ``out`` (out_dim, H*W); coef, freq (h, w, C)."""
    h, w, C = coef.shape
    half = C // 2
    H, W = coord_y.shape[0], coord_x.shape[0]
    ys = [axis_hits(coord_y, -1.0 / h, h), axis_hits(coord_y, 1.0 / h, h)]
    xs = [axis_hits(coord_x, -1.0 / w, w), axis_hits(coord_x, 1.0 / w, w)]
    corners = [(ys[0], xs[0]), (ys[0], xs[1]), (ys[1], xs[0]), (ys[1], xs[1])]
    rows = max(1, chunk_queries // W)
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        pieces, areas = [], []
        for (iy, ry), (ix, rx) in corners:
            ry_c = ry[r0:r1]
            c_ = coef[iy[r0:r1]][:, ix]   # (R, W, C)
            f_ = freq[iy[r0:r1]][:, ix]
            f = (f_[..., :half] * ry_c[:, None, None]
                 + f_[..., half:] * rx[None, :, None]) + phase
            basis = torch.cat([torch.cos(math.pi * f), torch.sin(math.pi * f)],
                              -1)
            pieces.append((c_, basis))
            areas.append(torch.abs(ry_c[:, None] * rx[None, :]) + 1e-9)
        tot = areas[0] + areas[1] + areas[2] + areas[3]
        # diagonal-opposite area swap
        feats = [(areas[3 - k] / tot)[..., None] * pieces[k][0] * pieces[k][1]
                 for k in range(4)]
        x = torch.cat(feats, -1).reshape(-1, 4 * C)
        for i, (wl, bl) in enumerate(mlp):
            x = F.linear(x, wl, bl)
            if i < len(mlp) - 1:
                x = fnn.relu(x)
        out[:, r0 * W:r1 * W] = x.T


def _check(coef, freq, coord_y, coord_x, phase, mlp):
    if coef.ndim != 4 or freq.shape != coef.shape:
        raise ValueError(f"coef/freq must be (B, h, w, C): {tuple(coef.shape)}"
                         f", {tuple(freq.shape)}")
    B, C = coef.shape[0], coef.shape[-1]
    if coord_y.ndim == 1 and coord_x.ndim == 1:
        if B != 1 or phase.shape not in ((C // 2,), (1, C // 2)):
            raise ValueError(f"1-D axes take coef of batch 1 and phase "
                             f"({C // 2},); got B={B}, phase "
                             f"{tuple(phase.shape)}")
    elif coord_y.ndim == 2 and coord_x.ndim == 2:
        if (coord_y.shape[0], coord_x.shape[0]) != (B, B):
            raise ValueError(f"coord_y/coord_x must be (B, H)/(B, W) with "
                             f"B={B}: {tuple(coord_y.shape)}, "
                             f"{tuple(coord_x.shape)}")
        if phase.shape != (B, C // 2):
            raise ValueError(f"phase must be ({B}, {C // 2}), got "
                             f"{tuple(phase.shape)}")
    else:
        raise ValueError("coord_y/coord_x must be both 1-D (batch 1) or both "
                         "(B, H)/(B, W)")
    if len(mlp) < 2 or mlp[0][0].shape != (C, 4 * C):
        raise ValueError("mlp must start with a 4C -> C linear")
    for wl, _ in mlp[1:-1]:
        if wl.shape != (C, C):
            raise ValueError(f"hidden layers must be C -> C, got "
                             f"{tuple(wl.shape)}")
    if mlp[-1][0].shape[1] != C:
        raise ValueError("the last linear must take C inputs")


def pack_mlp(mlp):
    """The MLP as K2 reads it: one flat f32 buffer of each layer's weight
    as (in, out) row-major, then its bias, in layer order."""
    return torch.cat([t.detach().float().reshape(-1)
                      for wl, bl in mlp for t in (wl.T.contiguous(), bl)])


def affine_info(coef, freq, coord_y, coord_x, phase, mlp, packed=None):
    """K2 on CUDA (hidden 128 or 256, out_dim <= 1024, B <= 65535), the
    twin on CPU.  ``packed``: ``pack_mlp(mlp)`` if the caller keeps it,
    else packed here."""
    _check(coef, freq, coord_y, coord_x, phase, mlp)
    if coef.device.type == "cpu":
        return affine_info_plain(coef, freq, coord_y, coord_x, phase, mlp)
    if coef.device.type != "cuda":
        raise ValueError(f"affine_info: unsupported device {coef.device}")
    B, h, w, C = coef.shape
    out_dim = mlp[-1][0].shape[0]
    if B > KERNEL_MAX_BATCH:
        raise ValueError(f"K2 takes B <= {KERNEL_MAX_BATCH}; got B={B}")
    if C not in KERNEL_HIDDEN or out_dim > KERNEL_MAX_OUT:
        raise ValueError(f"K2 takes hidden in {KERNEL_HIDDEN} and out_dim <= "
                         f"{KERNEL_MAX_OUT}; got C={C}, out_dim={out_dim}")
    if packed is None:
        packed = pack_mlp(mlp)
    if packed.numel() != sum(wl.numel() + bl.numel() for wl, bl in mlp):
        raise ValueError("packed MLP does not match mlp (re-run freeze()?)")
    coord_y, coord_x, phase = _batched(coord_y, coord_x, phase)
    H, W = coord_y.shape[1], coord_x.shape[1]
    coef, freq = coef.contiguous(), freq.contiguous()
    coord_y, coord_x = coord_y.contiguous(), coord_x.contiguous()
    phase = phase.contiguous()
    out = torch.empty((out_dim, B * H * W), device=coef.device)
    cuda.check_cuda("linf_info", coef, freq, coord_y, coord_x, phase, packed,
                    out)
    p = cuda.ptr
    cuda.launch("linf_info", p(coef), p(freq), p(coord_y), p(coord_x),
                p(phase), p(packed), p(out), B, h, w, H, W, C, len(mlp) - 2,
                out_dim, ctypes.c_float(1.0 / h), ctypes.c_float(1.0 / w))
    return out
