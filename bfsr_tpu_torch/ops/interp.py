"""Resampling ops with PyTorch numerical semantics, NHWC layout.

The counterpart of ``bfsr_tpu/ops/interp.py`` for the four the inference
and training paths use:

* ``grid_sample_bilinear`` — ``F.grid_sample(mode='bilinear',
  align_corners=False)``, border or zero padding, at any query set
  (B, ..., 2): the LR add-back at coords that are not a regular grid;
* ``grid_sample_bilinear_separable`` — the same on a *regular* grid per
  sample, as two axis interpolations: the LR add-back of the LINF pixel
  model (the predictors' grid, the trainer's per-sample crops);
* ``resize_bilinear`` — ``F.interpolate(mode='bilinear')`` with torch's
  per-axis source positions, both ``align_corners`` settings: the UNets'
  up paths, the LINF LR-embedding resize, SRFlow's LR-up image and its
  ``fea_up0`` down-resize;
* ``resize_nearest`` — ``F.interpolate(mode='nearest')``: the RRDB
  up path and the block-stack concat of the SRFlow conditioning.

Coordinates follow the LINF convention: axis 0 of a coord is the height.
"""

import torch


def _unnormalize(coord, size):
    """align_corners=False: x_pix = ((x + 1) * size - 1) / 2."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _sample_axis_weights(coord, n):
    """(i0, i1, w0, w1) of 1-D bilinear border-clamped sampling at
    ``coord`` in [-1, 1]."""
    f = torch.clamp(_unnormalize(coord, n), 0.0, n - 1.0)
    i0 = torch.floor(f)
    w1 = f - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), 1.0 - w1, w1


def grid_sample_bilinear(x, coord, padding_mode="border"):
    """Bilinear grid sample, align_corners=False, at any query set.

    x: (B, H, W, C); coord: (B, ..., 2) in (h, w) order.  padding_mode:
    'border' (clamp) or 'zeros'.  Returns (B, ..., C), the four corners
    weighted as ``bfsr_tpu/ops/interp.py:grid_sample_bilinear`` weights
    them."""
    B, H, W, C = x.shape
    fy = _unnormalize(coord[..., 0], H)
    fx = _unnormalize(coord[..., 1], W)
    if padding_mode == "border":
        fy = torch.clamp(fy, 0.0, H - 1.0)
        fx = torch.clamp(fx, 0.0, W - 1.0)
    elif padding_mode != "zeros":
        raise ValueError(f"padding_mode must be 'border' or 'zeros', got "
                         f"{padding_mode!r}")
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy, wx = (fy - y0)[..., None], (fx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    flat = x.reshape(B, H * W, C)

    def corner(iy, ix):
        idx = (torch.clamp(iy, 0, H - 1) * W
               + torch.clamp(ix, 0, W - 1)).reshape(B, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, C))
        v = v.reshape(*iy.shape, C)
        if padding_mode == "zeros":
            inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            v = torch.where(inb[..., None], v, torch.zeros_like(v))
        return v

    return (corner(y0, x0) * (1 - wy) * (1 - wx)
            + corner(y0, x0 + 1) * (1 - wy) * wx
            + corner(y0 + 1, x0) * wy * (1 - wx)
            + corner(y0 + 1, x0 + 1) * wy * wx)


def grid_sample_bilinear_separable(x, coord_y, coord_x):
    """Bilinear grid sample (border padding) at the regular grid
    coord_y x coord_x.

    x: (B, H, W, C); coord_y: (Hg,) and coord_x: (Wg,), one grid for the
    batch, or (B, Hg) and (B, Wg), each sample's own.  Returns
    (B, Hg, Wg, C).
    """
    B, H, W, _ = x.shape
    if coord_y.ndim == 1:
        coord_y, coord_x = coord_y.expand(B, -1), coord_x.expand(B, -1)
    y0, y1, wy0, wy1 = _sample_axis_weights(coord_y, H)
    x0, x1, wx0, wx1 = _sample_axis_weights(coord_x, W)

    def rows_at(i):
        return torch.take_along_dim(x, i[:, :, None, None], dim=1)

    def cols_at(t, i):
        return torch.take_along_dim(t, i[:, None, :, None], dim=2)

    rows = (rows_at(y0) * wy0[:, :, None, None]
            + rows_at(y1) * wy1[:, :, None, None])
    return (cols_at(rows, x0) * wx0[:, None, :, None]
            + cols_at(rows, x1) * wx1[:, None, :, None])


def _resize_axis_weights(in_size, out_size, align_corners, device):
    """Per-output (i0, i1, w1) for 1-D linear resize, torch semantics."""
    out_idx = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        src = out_idx * ((in_size - 1) / (out_size - 1))
    else:
        src = (out_idx + 0.5) * (in_size / out_size) - 0.5
    src = torch.clamp(src, 0.0, in_size - 1.0)
    i0 = torch.floor(src)
    w1 = src - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=in_size - 1), w1


def resize_bilinear(x, out_hw, align_corners=False):
    """F.interpolate(mode='bilinear') on NHWC: (B, H, W, C) -> (B, h, w, C)."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    y0, y1, wy = _resize_axis_weights(H, oh, align_corners, x.device)
    x0, x1, wx = _resize_axis_weights(W, ow, align_corners, x.device)
    top = x[:, y0]
    xh = top + (x[:, y1] - top) * wy[None, :, None, None]
    left = xh[:, :, x0]
    return left + (xh[:, :, x1] - left) * wx[None, None, :, None]


def _nearest_index(in_size, out_size, device):
    """floor(i * in / out) in float32, as ``bfsr_tpu/ops/interp.py``."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    idx = torch.floor(i * (in_size / out_size)).long()
    return torch.clamp(idx, 0, in_size - 1)


def resize_nearest(x, out_hw):
    """F.interpolate(mode='nearest') on NHWC: (B, H, W, C) -> (B, h, w, C)."""
    _, H, W, _ = x.shape
    iy = _nearest_index(H, out_hw[0], x.device)
    ix = _nearest_index(W, out_hw[1], x.device)
    return x[:, iy][:, :, ix]
