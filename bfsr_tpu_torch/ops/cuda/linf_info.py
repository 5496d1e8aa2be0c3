"""K2: LINF per-query affine info on a regular HR grid, fully fused.

Kernel: ``bfsr_tpu_torch/csrc/linf_info.cu``, which replaces
``bfsr_tpu/ops/pallas/linf_info.py:_kernel`` (``fused_affine_info_cm``).
Its twin is ``affine_info_plain``, the computation of
``bfsr_tpu/models/linf.py:linf_affine_info_grid`` over query-row chunks.

Inputs: coef, freq (1, h, w, C) NHWC — the Fourier head's conv outputs;
coord_y (H,), coord_x (W,) — grid-center coordinates of the HR rows and
columns; phase (C/2,) — the phase linear of the relative cell; mlp — list
of (weight (out, in), bias) pairs: 4C -> C, (C -> C) x n_hidden,
C -> out_dim (60 for the pixel model, 2dL = 540 for the d = 27 patch
model).  Output: channel-major info (out_dim, H*W).
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


def affine_info_plain(coef, freq, coord_y, coord_x, phase, mlp,
                      chunk_queries=CHUNK_QUERIES):
    """Plain twin of K2: gathers, cos/sin and matmuls over row chunks."""
    _, h, w, C = coef.shape
    half = C // 2
    H, W = coord_y.shape[0], coord_x.shape[0]
    ys = [axis_hits(coord_y, -1.0 / h, h), axis_hits(coord_y, 1.0 / h, h)]
    xs = [axis_hits(coord_x, -1.0 / w, w), axis_hits(coord_x, 1.0 / w, w)]
    corners = [(ys[0], xs[0]), (ys[0], xs[1]), (ys[1], xs[0]), (ys[1], xs[1])]
    out_dim = mlp[-1][0].shape[0]
    out = torch.empty((out_dim, H * W), dtype=coef.dtype, device=coef.device)
    rows = max(1, chunk_queries // W)
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        pieces, areas = [], []
        for (iy, ry), (ix, rx) in corners:
            ry_c = ry[r0:r1]
            c_ = coef[0][iy[r0:r1]][:, ix]   # (R, W, C)
            f_ = freq[0][iy[r0:r1]][:, ix]
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
    return out


def _check(coef, freq, coord_y, coord_x, phase, mlp):
    if coef.ndim != 4 or coef.shape[0] != 1 or freq.shape != coef.shape:
        raise ValueError(f"coef/freq must be (1, h, w, C): {tuple(coef.shape)}"
                         f", {tuple(freq.shape)}")
    C = coef.shape[-1]
    if phase.shape != (C // 2,):
        raise ValueError(f"phase must be ({C // 2},), got {tuple(phase.shape)}")
    if coord_y.ndim != 1 or coord_x.ndim != 1:
        raise ValueError("coord_y/coord_x must be 1-D")
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
    """K2 on CUDA (hidden 128 or 256, out_dim <= 1024), the twin on CPU.
    ``packed``: ``pack_mlp(mlp)`` if the caller keeps it, else packed here."""
    _check(coef, freq, coord_y, coord_x, phase, mlp)
    if coef.device.type == "cpu":
        return affine_info_plain(coef, freq, coord_y, coord_x, phase, mlp)
    if coef.device.type != "cuda":
        raise ValueError(f"affine_info: unsupported device {coef.device}")
    _, h, w, C = coef.shape
    out_dim = mlp[-1][0].shape[0]
    if C not in KERNEL_HIDDEN or out_dim > KERNEL_MAX_OUT:
        raise ValueError(f"K2 takes hidden in {KERNEL_HIDDEN} and out_dim <= "
                         f"{KERNEL_MAX_OUT}; got C={C}, out_dim={out_dim}")
    if packed is None:
        packed = pack_mlp(mlp)
    if packed.numel() != sum(wl.numel() + bl.numel() for wl, bl in mlp):
        raise ValueError("packed MLP does not match mlp (re-run freeze()?)")
    H, W = coord_y.shape[0], coord_x.shape[0]
    coef, freq = coef.contiguous(), freq.contiguous()
    coord_y, coord_x = coord_y.contiguous(), coord_x.contiguous()
    phase = phase.contiguous()
    out = torch.empty((out_dim, H * W), device=coef.device)
    cuda.check_cuda("linf_info", coef, freq, coord_y, coord_x, phase, packed,
                    out)
    p = cuda.ptr
    cuda.launch("linf_info", p(coef), p(freq), p(coord_y), p(coord_x),
                p(phase), p(packed), p(out), h, w, H, W, C, len(mlp) - 2,
                out_dim, ctypes.c_float(1.0 / h), ctypes.c_float(1.0 / w))
    return out
