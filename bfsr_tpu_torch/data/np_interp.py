"""Host-side (numpy) resampling on (H, W, C) arrays: the bilinear resize
with ``F.interpolate(mode='bilinear')`` semantics, and the reference's PIL
bicubic downsampler.

The counterpart of ``bfsr_tpu/data/np_interp.py``; PIL is imported by
``resize_fn_pil`` alone, where it is called.
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


def resize_fn_pil(img_hwc, size):
    """The reference wrappers' ``resize_fn``: float [0, 1] HWC -> uint8
    (truncating, as torchvision's ToPILImage does) -> PIL BICUBIC resize
    -> float [0, 1].  size: int (the shorter side, torchvision Resize
    semantics) or (h, w)."""
    from PIL import Image

    arr = img_hwc
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    pil = Image.fromarray(arr)
    if isinstance(size, int):
        w, h = pil.size
        if h <= w:
            oh, ow = size, max(1, round(size * w / h))
        else:
            ow, oh = size, max(1, round(size * h / w))
    else:
        oh, ow = size
    out = pil.resize((ow, oh), Image.BICUBIC)
    return np.asarray(out, dtype=np.float32) / 255.0
