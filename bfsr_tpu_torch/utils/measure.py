"""SRFlow-side metrics on uint8 images: the counterpart of
``bfsr_tpu/utils/measure.py`` (the reference's ``SRFlow-LP/code/
Measure.py``).

PSNR and SSIM as skimage computes them (``peak_signal_noise_ratio``;
``structural_similarity`` with a 7x7 uniform window, the sample
covariance, averaged over channels), LPIPS on [-1, 1] images
(``models/lpips.py``), the natural sort, ``Measure`` and the
directory-against-directory CLI:

    python -m bfsr_tpu_torch.utils.measure -dirA SR -dirB GT \\
        [-type png] [--lpips_weights lpips_alex.pth] [--device cuda|cpu]

LPIPS runs on ``--device``, the card unless ``cpu`` is asked for.
"""

import glob
import os
import re
import time
from collections import OrderedDict

import numpy as np
from scipy.ndimage import uniform_filter


def psnr_uint8(img_a, img_b, data_range=255.0):
    """skimage's ``peak_signal_noise_ratio``."""
    a = np.asarray(img_a, dtype=np.float64)
    b = np.asarray(img_b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    return float(10.0 * np.log10((data_range ** 2) / mse))


def _ssim_channel(x, y, data_range, win_size=7, k1=0.01, k2=0.03):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    npix = win_size ** 2
    cov_norm = npix / (npix - 1)  # the sample covariance, skimage's default
    ux = uniform_filter(x, win_size)
    uy = uniform_filter(y, win_size)
    uxx = uniform_filter(x * x, win_size)
    uyy = uniform_filter(y * y, win_size)
    uxy = uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    pad = (win_size - 1) // 2
    return s[pad:-pad, pad:-pad].mean()


def ssim_uint8(img_a, img_b, data_range=255.0):
    """skimage's ``structural_similarity(multichannel=True)``."""
    a = np.asarray(img_a)
    b = np.asarray(img_b)
    if a.ndim == 2:
        return float(_ssim_channel(a, b, data_range))
    return float(np.mean([_ssim_channel(a[..., c], b[..., c], data_range)
                          for c in range(a.shape[-1])]))


def natsorted(paths):
    """Natural sort: digit runs compare as numbers, the rest lower-cased."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


class Measure:
    """PSNR, SSIM and LPIPS of two uint8 HWC images; LPIPS is nan without
    an ``lpips_model`` (``models.lpips.LPIPS``)."""

    def __init__(self, lpips_model=None):
        self.lpips_model = lpips_model

    def measure(self, img_a, img_b):
        return [self.psnr(img_a, img_b), self.ssim(img_a, img_b),
                self.lpips(img_a, img_b)]

    def psnr(self, img_a, img_b):
        return psnr_uint8(img_a, img_b)

    def ssim(self, img_a, img_b):
        return ssim_uint8(img_a, img_b)

    def lpips(self, img_a, img_b):
        if self.lpips_model is None:
            return float("nan")
        ta = np.asarray(img_a, np.float32)[None] / 127.5 - 1.0
        tb = np.asarray(img_b, np.float32)[None] / 127.5 - 1.0
        return self.lpips_model.score(ta, tb)


def measure_dirs(dir_a, dir_b, ext="png", lpips_model=None, verbose=False):
    """The mean {'psnr', 'ssim', 'lpips'} of the images of ``dir_a``
    against those of ``dir_b``, paired in natural order."""
    from PIL import Image

    vprint = print if verbose else (lambda *_: None)
    t_init = time.time()
    paths_a = natsorted(glob.glob(os.path.join(dir_a, f"*.{ext}")))
    paths_b = natsorted(glob.glob(os.path.join(dir_b, f"*.{ext}")))
    measure = Measure(lpips_model)
    results = []
    for pa, pb in zip(paths_a, paths_b):
        a = np.asarray(Image.open(pa).convert("RGB"))
        b = np.asarray(Image.open(pb).convert("RGB"))
        res = OrderedDict()
        res["psnr"], res["ssim"], res["lpips"] = measure.measure(a, b)
        vprint(f"{os.path.basename(pa)}, {os.path.basename(pb)}, "
               f"{res['psnr']:0.2f}, {res['ssim']:0.3f}, {res['lpips']:0.3f}")
        results.append(res)
    out = {k: float(np.mean([r[k] for r in results]))
           for k in ("psnr", "ssim", "lpips")}
    vprint(f"Final Result: {out['psnr']:0.2f}, {out['ssim']:0.3f}, "
           f"{out['lpips']:0.3f}, {time.time() - t_init:0.1f}s")
    return out


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-dirA", default="", type=str)
    parser.add_argument("-dirB", default="", type=str)
    parser.add_argument("-type", default="png")
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    lpips_model = None
    if args.lpips_weights:
        from bfsr_tpu_torch.models.lpips import load_lpips

        lpips_model = load_lpips(args.lpips_weights, args.device)
    if args.dirA and args.dirB:
        return measure_dirs(args.dirA, args.dirB, ext=args.type,
                            lpips_model=lpips_model, verbose=True)
    return None


if __name__ == "__main__":
    main()
