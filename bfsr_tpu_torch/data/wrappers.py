"""Dataset wrappers, host-side numpy: the counterpart of
``bfsr_tpu/data/wrappers.py``'s ``sr-implicit-paired-fast`` and
``sr-implicit-paired-fast-patch`` (the wrappers of the paired eval
configs), ``sr-implicit-downsampled-fast`` (the downsampling eval configs'
and the trainer's validation wrapper) and
``sr-implicit-downsampled-fast-patch-test`` (its patch form under
``test.py --patch``), ``sr-implicit-downsampled-fast-crop`` (the
trainer's) and ``sr-implicit-downsampled-fast-crop-patch`` (the patch
trainer's).

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

The downsampling wrappers take HR images too (``downsample_crop``): a
scale from U(``scale_min``, ``scale_max``); without ``inp_size`` the whole
image, cut to a multiple of the scale, and its PIL-bicubic LR; with it a
random square HR crop of round(``inp_size`` x scale) and an
``inp_size``^2 LR.  ``sr-implicit-downsampled-fast`` then queries the
whole HR grid, or, with ``inp_size``, a random subset of ``inp_size``^2
HR queries drawn by ``np.random.choice`` (not a grid: ``eval_psnr``
predicts each at its own coordinate).  Its draws follow the JAX
wrapper's, from ``random`` and ``np.random`` in the same order.

The paired eval wrappers take a dataset of (LR, HR) float32 HWC arrays in
[0, 1].  Each item is a dict of arrays:
``inp`` (h, w, 3), ``coord`` ((H, W, 2) grid centres in [-1, 1], axis 0
the height), ``cell`` ((2,) = (2/H, 2/W)), ``gt`` (H, W, 3) and
``gt_lr_up``, the up-down-up residual of the normalised LR image.

The patch eval wrappers unfold the residual into ps x ps patches at
stride ps in (c, ky, kx) channel order and query the patch centres.  Like
the reference, the paired one always pads the HR grid, even where ps
divides it: a centre that falls in the padding gets zero coords, and
``eval_psnr`` crops the folded image back to ``gt``.

The four flat LIIF-style wrappers (``sr-implicit-paired``,
``sr-implicit-downsampled``, ``sr-implicit-uniform-varied`` and, with
stride-1 patches, ``sr-implicit-downsampled-fast-patch``) follow the JAX
wrappers of the same names draw for draw: the same ``random`` and
``np.random`` calls in the same order, so one ``random.seed`` and one
``np.random.seed`` give the same items.  The flat ones emit per-query
arrays: ``coord`` (N, 2), ``cell`` (N, 2), ``gt`` (N, 3), all of the HR
grid's pixels or a random ``sample_q`` of them (``np.random.choice``
without replacement); ``sr-implicit-downsampled-fast-patch`` keeps its
queries laid out (``inp_size``, ``inp_size``) as a random subset of the
HR grid, as ``sr-implicit-downsampled-fast`` does.

Every wrapper computes its up-down-up residual with ``residuals``, on the
native host library (``native.updownup_residual``), as the JAX wrappers
do where their library is built; ``residuals_np`` is its numpy twin.

``batches(dataset)`` adds the batch axis, as the JAX package's loader does
at batch size 1.
"""

import math
import random

import numpy as np

from bfsr_tpu_torch import native
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
    from its up-down-up copy; float32, from the native host library
    (``native.updownup_residual``)."""
    return native.updownup_residual((crop_lr - 0.5) / 0.5, hr_hw)


def residuals_np(crop_lr, hr_hw):
    """``residuals``' plain numpy twin (three ``resize_bilinear_np``;
    within ~3e-7 of it: the native code interpolates x first and may fuse
    multiply-adds)."""
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


def flat_samples(crop_hr, sample_q=None):
    """The flat wrappers' queries: (coord (N, 2), cell (N, 2), rgb (N, 3))
    of every pixel of ``crop_hr``, or of ``sample_q`` of them drawn by
    ``np.random.choice`` without replacement."""
    coord = make_coord(crop_hr.shape[:2])
    rgb = crop_hr.reshape(-1, crop_hr.shape[-1])
    if sample_q is not None:
        sel = np.random.choice(len(coord), sample_q, replace=False)
        coord, rgb = coord[sel], rgb[sel]
    cell = np.ones_like(coord)
    cell[:, 0] *= 2 / crop_hr.shape[0]
    cell[:, 1] *= 2 / crop_hr.shape[1]
    return coord, cell, rgb


@register("sr-implicit-paired")
class SRImplicitPaired:
    """Paired LR/HR, flat queries: the whole LR (HR cut to s times it) or
    a random ``inp_size``^2 LR crop and its HR, the flips, then every HR
    pixel or ``sample_q`` of them."""

    def __init__(self, dataset, inp_size=None, augment=False, sample_q=None):
        self.dataset = dataset
        self.inp_size = inp_size
        self.augment = augment
        self.sample_q = sample_q

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        img_lr, img_hr = self.dataset[idx]
        s = img_hr.shape[0] // img_lr.shape[0]
        if self.inp_size is None:
            h_lr, w_lr = img_lr.shape[:2]
            crop_lr, crop_hr = img_lr, img_hr[:h_lr * s, :w_lr * s]
        else:
            n = self.inp_size
            x0 = random.randint(0, img_lr.shape[0] - n)
            y0 = random.randint(0, img_lr.shape[1] - n)
            crop_lr = img_lr[x0:x0 + n, y0:y0 + n]
            crop_hr = img_hr[x0 * s:(x0 + n) * s, y0 * s:(y0 + n) * s]
        aug = augment_factory(self.augment)
        crop_lr, crop_hr = aug(crop_lr), aug(crop_hr)
        coord, cell, rgb = flat_samples(crop_hr, self.sample_q)
        return {"inp": crop_lr, "coord": coord, "cell": cell, "gt": rgb}


@register("sr-implicit-uniform-varied")
class SRImplicitUniformVaried:
    """Paired, the HR resized (PIL bicubic) to a side growing linearly with
    the index from ``size_min`` to ``size_max``, a horizontal flip of both
    with probability 1/2 (``augment``), an optional second resize to
    ``gt_resize``, then flat queries as ``sr-implicit-paired``."""

    def __init__(self, dataset, size_min, size_max=None, augment=False,
                 gt_resize=None, sample_q=None):
        self.dataset = dataset
        self.size_min = size_min
        self.size_max = size_max if size_max is not None else size_min
        self.augment = augment
        self.gt_resize = gt_resize
        self.sample_q = sample_q

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        img_lr, img_hr = self.dataset[idx]
        p = idx / (len(self.dataset) - 1)
        side = round(self.size_min + (self.size_max - self.size_min) * p)
        img_hr = resize_fn_pil(img_hr, side)
        if self.augment and random.random() < 0.5:
            img_lr = np.ascontiguousarray(img_lr[:, ::-1])
            img_hr = np.ascontiguousarray(img_hr[:, ::-1])
        if self.gt_resize is not None:
            img_hr = resize_fn_pil(img_hr, self.gt_resize)
        coord, cell, rgb = flat_samples(img_hr, self.sample_q)
        return {"inp": img_lr, "coord": coord, "cell": cell, "gt": rgb}


def downsample_crop(img, s, inp_size):
    """(LR, HR, h_lr, w_lr, h_hr, w_hr) at scale ``s``: without
    ``inp_size`` the image cut to round(floor(H / s) s) x round(floor(W /
    s) s) and its PIL-bicubic LR; with it a random square HR crop of
    round(``inp_size`` s) (two ``random.randint`` draws, both bounded by
    the height, as the JAX wrapper draws them) and its ``inp_size``^2
    LR."""
    if inp_size is None:
        h_lr = math.floor(img.shape[0] / s + 1e-9)
        w_lr = math.floor(img.shape[1] / s + 1e-9)
        h_hr, w_hr = round(h_lr * s), round(w_lr * s)
        crop_hr = img[:h_hr, :w_hr]
        return (resize_fn_pil(crop_hr, (h_lr, w_lr)), crop_hr, h_lr, w_lr,
                h_hr, w_hr)
    h_lr = w_lr = inp_size
    h_hr = w_hr = round(inp_size * s)
    x0 = random.randint(0, img.shape[0] - w_hr)
    y0 = random.randint(0, img.shape[1] - w_hr)
    crop_hr = img[x0:x0 + w_hr, y0:y0 + w_hr]
    return resize_fn_pil(crop_hr, w_lr), crop_hr, h_lr, w_lr, h_hr, w_hr


class _Downsampled:
    """The downsampling wrappers' arguments and their per-item draws: a
    scale, the crop and the flips."""

    def __init__(self, dataset, inp_size=None, scale_min=1, scale_max=None,
                 augment=False, patch_size=3):
        self.dataset = dataset
        self.inp_size = inp_size
        self.scale_min = scale_min
        self.scale_max = scale_max if scale_max is not None else scale_min
        self.augment = augment
        self.patch_size = patch_size

    def __len__(self):
        return len(self.dataset)

    def _crop(self, idx):
        s = random.uniform(self.scale_min, self.scale_max)
        crop_lr, crop_hr, h_lr, w_lr, h_hr, w_hr = downsample_crop(
            self.dataset[idx], s, self.inp_size)
        aug = augment_factory(self.augment)
        return aug(crop_lr), aug(crop_hr), h_lr, w_lr, h_hr, w_hr


@register("sr-implicit-downsampled")
class SRImplicitDownsampled(_Downsampled):
    """HR images downsampled on the fly (``_Downsampled``), flat queries
    as ``sr-implicit-paired``: every HR pixel or ``sample_q`` of them."""

    def __init__(self, dataset, inp_size=None, scale_min=1, scale_max=None,
                 augment=False, sample_q=None):
        super().__init__(dataset, inp_size, scale_min, scale_max, augment)
        self.sample_q = sample_q

    def __getitem__(self, idx):
        crop_lr, crop_hr = self._crop(idx)[:2]
        coord, cell, rgb = flat_samples(crop_hr, self.sample_q)
        return {"inp": crop_lr, "coord": coord, "cell": cell, "gt": rgb}


@register("sr-implicit-downsampled-fast")
class SRImplicitDownsampledFast(_Downsampled):
    """HR images downsampled on the fly: the HR grid's coords, pixels,
    the LR's up-down-up residual (``gt_lr_up``) and the HR residual
    against the LR-up (``gt_pixel``); with ``inp_size`` a random subset of
    ``inp_size``^2 of the crop's HR queries, laid out (inp_size, inp_size)
    but not a grid."""

    def __init__(self, dataset, inp_size=None, scale_min=1, scale_max=None,
                 augment=False):
        super().__init__(dataset, inp_size, scale_min, scale_max, augment)

    def __getitem__(self, idx):
        crop_lr, crop_hr, h_lr, w_lr, h_hr, w_hr = self._crop(idx)
        coord = make_coord((h_hr, w_hr), flatten=False)
        lr_up, lr_up_residual = residuals(crop_lr, crop_hr.shape[:2])
        hr_residual = (((crop_hr - 0.5) / 0.5) - lr_up).astype(np.float32)
        gt = crop_hr
        if self.inp_size is not None:
            sel = np.random.choice(h_hr * w_hr, h_lr * w_lr, replace=False)

            def pick(a):
                return a.reshape(-1, a.shape[-1])[sel].reshape(h_lr, w_lr, -1)

            coord, gt, lr_up_residual, hr_residual = (
                pick(a) for a in (coord, gt, lr_up_residual, hr_residual))
        return {"inp": crop_lr, "coord": coord,
                "cell": make_cell(crop_hr.shape[:2]), "gt": gt,
                "gt_pixel": hr_residual, "gt_lr_up": lr_up_residual}


@register("sr-implicit-downsampled-fast-patch")
class SRImplicitDownsampledFastPatch(_Downsampled):
    """``sr-implicit-downsampled-fast`` for a patch model at train time:
    both residuals unfolded into stride-1 ps x ps patches ((c, ky, kx)
    order, zero padded by ps // 2) at every HR pixel; with ``inp_size`` a
    random subset of ``inp_size``^2 of the crop's queries (``gt``, the
    coords and both patch maps picked alike)."""

    def __getitem__(self, idx):
        crop_lr, crop_hr, h_lr, w_lr, h_hr, w_hr = self._crop(idx)
        ps = self.patch_size
        coord = make_coord((h_hr, w_hr), flatten=False)
        lr_up, lr_up_residual = residuals(crop_lr, crop_hr.shape[:2])
        hr_residual = (((crop_hr - 0.5) / 0.5) - lr_up).astype(np.float32)
        gt = crop_hr
        gt_patch = patchify_stride_1(hr_residual, ps)
        lr_up_patch = patchify_stride_1(lr_up_residual, ps)
        if self.inp_size is not None:
            sel = np.random.choice(h_hr * w_hr, h_lr * w_lr, replace=False)

            def pick(a):
                return a.reshape(-1, a.shape[-1])[sel].reshape(h_lr, w_lr, -1)

            coord, gt_patch, lr_up_patch, gt = (
                pick(a) for a in (coord, gt_patch, lr_up_patch, gt))
        return {"inp": crop_lr, "coord": coord,
                "cell": make_cell(crop_hr.shape[:2]), "gt": gt,
                "gt_patch": gt_patch, "gt_lr_up": lr_up_patch}


@register("sr-implicit-downsampled-fast-patch-test")
class SRImplicitDownsampledFastPatchTest(_Downsampled):
    """``sr-implicit-downsampled-fast`` for a patch model at test time:
    the residual unfolded into ps x ps patches at stride ps and the
    patch-centre coords, the grid padded only where ps does not divide
    it; with ``inp_size`` a random ``inp_size``^2 window of the HR
    grid."""

    def __getitem__(self, idx):
        crop_lr, crop_hr, h_lr, w_lr, h_hr, w_hr = self._crop(idx)
        ps = self.patch_size
        coord = make_coord((h_hr, w_hr), flatten=False)
        gt = crop_hr
        lr_up_residual = residuals(crop_lr, crop_hr.shape[:2])[1]
        if self.inp_size is not None:
            x0 = random.randint(0, h_hr - h_lr)
            y0 = random.randint(0, w_hr - w_lr)
            coord = coord[x0:x0 + h_lr, y0:y0 + w_lr]
            gt = crop_hr[x0:x0 + h_lr, y0:y0 + w_lr]
        h, w = coord.shape[:2]
        pad_h, pad_w = pad_amount(h, ps), pad_amount(w, ps)
        return {"inp": crop_lr,
                "gt_lr_up": patchify_stride_ps(lr_up_residual, ps, pad_h,
                                               pad_w),
                "coord": center_coords(coord, ps, pad_h, pad_w),
                "cell": make_cell(crop_hr.shape[:2]), "gt": gt}


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
