"""MATLAB-compatible ``imresize`` (antialiased bicubic / bilinear), numpy.

The counterpart of ``bfsr_tpu/ops/imresize.py:imresize``, the host path
the LR-consistency metric uses: source positions
``u = x / scale + 0.5 (1 - 1/scale)`` for 1-based x, the kernel widened by
1/scale when shrinking, symmetric (mirror-without-repeat) borders,
per-row weight normalisation, the axes in increasing-scale order, and
uint8 inputs re-quantised after each axis as MATLAB does.  Float64.
"""

from math import ceil

import numpy as np


def _cubic(x):
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2))


def _triangle(x):
    x = np.asarray(x, dtype=np.float64)
    return (x + 1.0) * ((x >= -1) & (x < 0)) + (1.0 - x) * ((x >= 0) & (x <= 1))


_KERNELS = {"bicubic": (_cubic, 4.0), "bilinear": (_triangle, 2.0)}


def _contributions(in_length, out_length, scale, kernel, k_width):
    if scale < 1:
        def h(x):
            return scale * kernel(scale * x)
        kernel_width = k_width / scale
    else:
        h = kernel
        kernel_width = k_width
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    p = int(ceil(kernel_width)) + 2
    indices = (left[:, None] + np.arange(p) - 1).astype(np.int64)
    weights = h(u[:, None] - indices - 1)
    weights = weights / weights.sum(axis=1, keepdims=True)
    aux = np.concatenate((np.arange(in_length),
                          np.arange(in_length - 1, -1, -1)))
    indices = aux[np.mod(indices, aux.size)]
    keep = np.any(weights != 0, axis=0)
    return weights[:, keep], indices[:, keep]


def _resize_along_axis(img, weights, indices, axis):
    moved = np.moveaxis(img, axis, 0)
    gathered = moved[indices]  # (out, taps, ...)
    w = weights.reshape(weights.shape + (1,) * (gathered.ndim - 2))
    return np.moveaxis((gathered * w).sum(axis=1), 0, axis)


def imresize(img, scale=None, method="bicubic", output_shape=None):
    """Resize an H x W or H x W x C array the MATLAB way, by ``scale`` or
    to ``output_shape`` (h, w).  uint8 in, uint8 out; else float64."""
    if method not in _KERNELS:
        raise ValueError(f"unknown method {method!r}")
    kernel, k_width = _KERNELS[method]
    if scale is not None:
        scale = float(scale)
        scales = [scale, scale]
        out_size = [int(ceil(scale * s)) for s in img.shape[:2]]
    elif output_shape is not None:
        out_size = list(output_shape[:2])
        scales = [out_size[0] / img.shape[0], out_size[1] / img.shape[1]]
    else:
        raise ValueError("either scale or output_shape is required")

    src_dtype = img.dtype
    work = np.asarray(img, dtype=np.float64)
    squeeze = work.ndim == 2
    if squeeze:
        work = work[:, :, None]
    taps = [_contributions(img.shape[k], out_size[k], scales[k], kernel,
                           k_width) for k in range(2)]
    for dim in np.argsort(np.array(scales)):  # more shrink first
        work = _resize_along_axis(work, *taps[int(dim)], int(dim))
        if src_dtype == np.uint8:
            work = np.around(np.clip(work, 0, 255)).astype(np.float64)
    if squeeze:
        work = work[:, :, 0]
    return work.astype(np.uint8) if src_dtype == np.uint8 else work
