"""Host-side (numpy) bilinear resize with ``F.interpolate(mode='bilinear')``
semantics, on (H, W, C) arrays.

The counterpart of ``bfsr_tpu/data/np_interp.py:resize_bilinear_np``; the
PIL bicubic ``resize_fn_pil`` of that module is not ported (the wrappers
that need it are not).
"""

import numpy as np


def _axis_weights(in_size, out_size, align_corners=False):
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = out_idx * ((in_size - 1) / (out_size - 1))
    else:
        src = (out_idx + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def resize_bilinear_np(x_hwc, out_hw, align_corners=False):
    """Bilinear resize of an (H, W, C) array to ``out_hw``."""
    h, w = x_hwc.shape[:2]
    oh, ow = out_hw
    y0, y1, wy = _axis_weights(h, oh, align_corners)
    x0, x1, wx = _axis_weights(w, ow, align_corners)
    top = x_hwc[y0]
    bot = x_hwc[y1]
    xh = top + (bot - top) * wy[:, None, None]
    left = xh[:, x0]
    right = xh[:, x1]
    return left + (right - left) * wx[None, :, None]
