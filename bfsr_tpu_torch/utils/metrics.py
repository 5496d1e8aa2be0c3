"""Evaluation metrics with the reference's protocols, host-side numpy.

The counterpart of ``bfsr_tpu/utils/metrics.py``:

* ``calc_psnr`` — shave-aware PSNR; Y channel (ITU gray coefficients) for
  ``benchmark`` datasets, RGB for ``div2k``;
* ``calculate_ssim`` — MATLAB-protocol SSIM on [0, 255] images, 11x11
  Gaussian window (sigma 1.5), 5-pixel valid crop.

Float64 numpy: they run once per image, on the host, after the image has
left the card.
"""

import numpy as np

_GRAY_COEFFS = np.array([65.738, 129.057, 25.064], dtype=np.float64) / 256.0


def calc_psnr(sr, hr, dataset=None, scale=1, rgb_range=1.0):
    """PSNR between (B, C, H, W) or (C, H, W) arrays.

    dataset: None (no shave), 'div2k' (shave ``scale``) or 'benchmark'
    (shave ``scale``, Y channel).
    """
    sr = np.asarray(sr, dtype=np.float64)
    hr = np.asarray(hr, dtype=np.float64)
    diff = (sr - hr) / rgb_range
    if diff.ndim == 3:
        diff = diff[None]
    if dataset is not None:
        if dataset == "benchmark":
            if diff.shape[1] > 1:
                diff = (diff * _GRAY_COEFFS.reshape(1, 3, 1, 1)).sum(
                    axis=1, keepdims=True)
        elif dataset != "div2k":
            raise NotImplementedError(dataset)
        diff = diff[..., scale:-scale, scale:-scale]
    return float(-10.0 * np.log10(np.mean(diff ** 2)))


def _gaussian_window(size=11, sigma=1.5):
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def _filter2d_valid(img, window):
    """'same' correlation with reflect-101 borders, then a 5-pixel crop
    (cv2.filter2D(...)[5:-5, 5:-5])."""
    pad = window.shape[0] // 2
    padded = np.pad(img, pad, mode="reflect")  # numpy 'reflect' = reflect-101
    k = window.shape[0]
    windows = np.lib.stride_tricks.sliding_window_view(padded, (k, k))
    return np.einsum("ijkl,kl->ij", windows, window)[5:-5, 5:-5]


def _ssim_single(img1, img2):
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window(11, 1.5)
    mu1 = _filter2d_valid(img1, window)
    mu2 = _filter2d_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2d_valid(img1 ** 2, window) - mu1_sq
    sigma2_sq = _filter2d_valid(img2 ** 2, window) - mu2_sq
    sigma12 = _filter2d_valid(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def calculate_ssim(img1, img2):
    """MATLAB-protocol SSIM; img1/img2 H x W or H x W x C in [0, 255]."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return float(_ssim_single(img1, img2))
    if img1.ndim == 3 and img1.shape[2] in (1, 3):
        return float(np.mean([_ssim_single(img1[:, :, i], img2[:, :, i])
                              for i in range(img1.shape[2])]))
    raise ValueError("Wrong input image dimensions.")
