"""Dataset wrappers, host-side numpy: the counterpart of
``bfsr_tpu/data/wrappers.py``'s ``sr-implicit-paired-fast`` and
``sr-implicit-paired-fast-patch`` (the wrappers of the LINF-LP eval
configs), ``sr-implicit-downsampled-fast-crop`` (the trainer's) and
``sr-implicit-downsampled-fast-crop-patch`` (the patch trainer's).

The train wrapper takes a dataset of HR float32 HWC images in [0, 1]; per
item it draws a scale from U(1, ``scale_max``), crops an HR window of
``inp_size`` x scale, downsamples it with PIL bicubic to the LR input,
flips both when ``augment``, and crops an ``inp_size``^2 window of the HR
grid with its coords, its HR pixels (``gt``), the up-down-up residual of
the LR (``gt_lr_up``) and the HR residual against the LR-up (``gt_pixel``).
Its draws come from Python's ``random``, in the JAX wrapper's order, so
the same ``random.seed`` gives the same crops.  The patch trainer's
wrapper crops an LR of ``inp_size`` x ps (the HR window too), unfolds
both residuals into stride-1 ps x ps patches ((c, ky, kx) order, zero
padded by ps // 2) and keeps those centred at every ps-th pixel of the
window, with their coords (``coord``, ``inp_size``^2 of them), the
window's own coords for the LR add-back (``interpolate_coord``) and the HR
window (``gt``); it pads the window only where ps does not divide it, as
the JAX wrapper does (``pad_amount``).

The eval wrappers take a dataset of (LR, HR) float32 HWC arrays in
[0, 1].  Each item is a dict of arrays:
``inp`` (h, w, 3), ``coord`` ((H, W, 2) grid centres in [-1, 1], axis 0
the height), ``cell`` ((2,) = (2/H, 2/W)), ``gt`` (H, W, 3) and
``gt_lr_up``, the up-down-up residual of the normalised LR image.

The patch wrapper unfolds the residual into ps x ps patches at stride ps
in (c, ky, kx) channel order and queries the patch centres.  Like the
reference, it always pads the HR grid, even where ps divides it: a centre
that falls in the padding gets zero coords, and ``eval_psnr`` crops the
folded image back to ``gt``.

``batches(dataset)`` adds the batch axis, as the JAX package's loader does
at batch size 1.  The eval configs use these wrappers with no arguments;
their train-time random crop and flips (``inp_size``, ``augment``) are not
ported.
"""

import random

import numpy as np

from bfsr_tpu_torch.data.np_interp import resize_bilinear_np, resize_fn_pil
from bfsr_tpu_torch.registry import register
from bfsr_tpu_torch.utils.coords import make_cell, make_coord


def updownup_residual(img_lr, hr_hw):
    """The LR image normalised to [-1, 1], bilinear up to ``hr_hw``, minus
    its up-down-up copy (up to ``hr_hw``, down to the LR size, up again)."""
    return residuals(img_lr, hr_hw)[1]


def residuals(crop_lr, hr_hw):
    """(lr_up, up-down-up residual) of an LR crop at the HR size: the LR
    normalised to [-1, 1], bilinear up to ``hr_hw``, and its difference
    from its up-down-up copy; float32."""
    lr_up = resize_bilinear_np((crop_lr - 0.5) / 0.5, hr_hw)
    lr_up_down = resize_bilinear_np(lr_up, crop_lr.shape[:2])
    return (lr_up.astype(np.float32),
            (lr_up - resize_bilinear_np(lr_up_down, hr_hw)).astype(np.float32))


def augment_factory(augment):
    """A random flip function (vertical, horizontal, transpose, each with
    probability 1/2, drawn now from ``random``), or the identity."""
    if not augment:
        return lambda x: x
    hflip = random.random() < 0.5
    vflip = random.random() < 0.5
    dflip = random.random() < 0.5

    def fn(x_hwc):
        if hflip:
            x_hwc = x_hwc[::-1, :, :]
        if vflip:
            x_hwc = x_hwc[:, ::-1, :]
        if dflip:
            x_hwc = np.transpose(x_hwc, (1, 0, 2))
        return np.ascontiguousarray(x_hwc)

    return fn


def patchify_stride_ps(x_hwc, ps, pad_end_h, pad_end_w):
    """Non-overlapping ps-stride unfold after zero end-padding; each
    patch flattened in (c, ky, kx) order."""
    x = np.pad(x_hwc, ((0, pad_end_h), (0, pad_end_w), (0, 0)))
    H, W, C = x.shape
    x = x.reshape(H // ps, ps, W // ps, ps, C).transpose(0, 2, 4, 1, 3)
    return np.ascontiguousarray(x.reshape(H // ps, W // ps, C * ps * ps))


def patchify_stride_1(x_hwc, ps):
    """'Same' stride-1 unfold with ps // 2 zero padding: each pixel's ps x
    ps patch flattened in (c, ky, kx) order."""
    pad = ps // 2
    x = np.pad(x_hwc, ((pad, pad), (pad, pad), (0, 0)))
    H, W, C = x_hwc.shape
    windows = np.lib.stride_tricks.sliding_window_view(x, (ps, ps),
                                                       axis=(0, 1))
    return np.ascontiguousarray(windows.reshape(H, W, C * ps * ps))


def pad_amount(n, ps):
    """The end padding that makes n a multiple of ps (0 if it is one)."""
    return (ps - n % ps) if n % ps else 0


def center_coords(coord_hw2, ps, pad_h, pad_w):
    """The patch-centre coords of a zero end-padded coord grid."""
    c = np.pad(coord_hw2, ((0, pad_h), (0, pad_w), (0, 0)))
    return np.ascontiguousarray(c[ps // 2::ps, ps // 2::ps, :])


@register("sr-implicit-paired-fast")
class SRImplicitPairedFast:
    """Paired LR/HR, whole images: the HR grid coords and the up-down-up
    residual, the HR cropped to a multiple of the LR size."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        img_lr, img_hr = self.dataset[idx]
        s = img_hr.shape[0] // img_lr.shape[0]
        hr_hw = (img_lr.shape[0] * s, img_lr.shape[1] * s)
        return {"inp": img_lr, "coord": make_coord(hr_hw, flatten=False),
                "cell": make_cell(hr_hw), "gt": img_hr[:hr_hw[0], :hr_hw[1]],
                "gt_lr_up": updownup_residual(img_lr, hr_hw)}


@register("sr-implicit-paired-fast-patch")
class SRImplicitPairedFastPatch:
    """``sr-implicit-paired-fast`` with the residual unfolded into ps x ps
    patches and the patch-centre coords."""

    def __init__(self, dataset, patch_size=3):
        self.dataset = dataset
        self.patch_size = patch_size

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        base = SRImplicitPairedFast([self.dataset[idx]])[0]
        ps = self.patch_size
        h, w = base["coord"].shape[:2]
        pad_h, pad_w = ps - h % ps, ps - w % ps  # always pads, as the reference
        return {"inp": base["inp"],
                "gt_lr_up": patchify_stride_ps(base["gt_lr_up"], ps, pad_h,
                                               pad_w),
                "coord": center_coords(base["coord"], ps, pad_h, pad_w),
                "cell": base["cell"], "gt": base["gt"]}


def train_crops(img, n_lr, scale_max, augment, window):
    """The train wrappers' draws from Python's ``random``, in the JAX
    wrappers' order: a scale s ~ U(1, ``scale_max``), an HR crop of round(
    ``n_lr`` s)^2 and its PIL-bicubic LR of ``n_lr``^2, the flips, then a
    ``window``^2 window of the HR grid.  Returns (LR crop, HR crop, the
    LR-up residual and the HR residual at the HR crop's size, its coords,
    the window's slice)."""
    s = random.uniform(1, scale_max)
    n_hr = round(n_lr * s)
    x0 = random.randint(0, img.shape[0] - n_hr)
    y0 = random.randint(0, img.shape[1] - n_hr)
    crop_hr = img[x0:x0 + n_hr, y0:y0 + n_hr]
    crop_lr = resize_fn_pil(crop_hr, (n_lr, n_lr))
    aug = augment_factory(augment)
    crop_lr, crop_hr = aug(crop_lr), aug(crop_hr)
    lr_up, lr_up_residual = residuals(crop_lr, crop_hr.shape[:2])
    hr_residual = (((crop_hr - 0.5) / 0.5) - lr_up).astype(np.float32)
    coord = make_coord(crop_hr.shape[:2], flatten=False)
    x0 = random.randint(0, n_hr - window)
    y0 = random.randint(0, n_hr - window)
    return (crop_lr, crop_hr, lr_up_residual, hr_residual, coord,
            np.s_[x0:x0 + window, y0:y0 + window])


@register("sr-implicit-downsampled-fast-crop")
class SRImplicitDownsampledFastCrop:
    """Train-time: one scale and aligned HR / coord / residual window crops
    per item (the JAX wrapper of the same name)."""

    def __init__(self, dataset, inp_size=48, scale_max=4, augment=False):
        self.dataset = dataset
        self.out_size = inp_size
        self.scale_max = scale_max
        self.augment = augment

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        crop_lr, crop_hr, lr_up_residual, hr_residual, coord, sl = \
            train_crops(self.dataset[idx], self.out_size, self.scale_max,
                        self.augment, self.out_size)
        return {"inp": crop_lr, "coord": coord[sl],
                "cell": make_cell(crop_hr.shape[:2]), "gt": crop_hr[sl],
                "gt_lr_up": lr_up_residual[sl], "gt_pixel": hr_residual[sl]}


@register("sr-implicit-downsampled-fast-crop-patch")
class SRImplicitDownsampledFastCropPatch:
    """The patch trainer's crops: ``sr-implicit-downsampled-fast-crop`` at
    an LR of ``inp_size`` x ps, with the residuals as stride-1 patches
    sampled at the ps-stride centres (the JAX wrapper of the same
    name)."""

    def __init__(self, dataset, inp_size=48, scale_max=4, augment=False,
                 patch_size=3):
        self.dataset = dataset
        self.out_size = inp_size * patch_size
        self.scale_max = scale_max
        self.augment = augment
        self.patch_size = patch_size

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        crop_lr, crop_hr, lr_up_residual, hr_residual, coord, sl = \
            train_crops(self.dataset[idx], self.out_size, self.scale_max,
                        self.augment, self.out_size)
        return {"inp": crop_lr, "cell": make_cell(crop_hr.shape[:2]),
                "gt": crop_hr[sl],
                **patch_centres(lr_up_residual, hr_residual, coord, sl,
                                self.patch_size)}


def patch_centres(lr_up_residual, hr_residual, coord, sl, ps):
    """The crop-patch wrapper's per-query arrays: both residuals of the HR
    crop unfolded into stride-1 ps x ps patches and taken, with their
    coords, at every ps-th pixel of the window ``sl`` (from ps // 2); the
    window's own coords as ``interpolate_coord``.  The centre grid pads
    the window only where ps does not divide it."""
    centre = np.s_[ps // 2::ps, ps // 2::ps]
    coord = coord[sl]
    h, w = coord.shape[:2]
    return {"coord": center_coords(coord, ps, pad_amount(h, ps),
                                   pad_amount(w, ps)),
            "gt_patch": np.ascontiguousarray(
                patchify_stride_1(hr_residual, ps)[sl][centre]),
            "gt_lr_up": np.ascontiguousarray(
                patchify_stride_1(lr_up_residual, ps)[sl][centre]),
            "interpolate_coord": np.ascontiguousarray(coord)}


def batches(dataset):
    """Each item of ``dataset`` as a batch of one (a leading axis)."""
    for i in range(len(dataset)):
        yield {k: np.asarray(v)[None] for k, v in dataset[i].items()}
