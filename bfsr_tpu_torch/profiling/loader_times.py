"""Host time of the trainers' data path: one crop sample split into its
stages, and the port's ``DataLoader`` batches/s, with the native residual
and with its numpy twin.

The samples are the real train wrappers' (``sr-implicit-downsampled-fast-
crop``, the pixel trainer's, LR 48^2; ``-crop-patch``, the patch
trainer's, LR 144^2 with 48^2 patch centres), each from an HR scale ~ U(1,
4), cut from smooth random DIV2K-size HR images (2040x1356, from numpy
seed 0).  ``stage_split`` calls the wrapper's own ``__getitem__`` with a
clock around each function of ``data/wrappers`` it reaches (``mock.patch``
shims, ``stage_clock``): the HR crop's PIL-bicubic LR (``resize_fn_pil``),
the flips (the function ``augment_factory`` returns), the up-down-up
residual (``residuals``: the native host library, or ``residuals_np``),
the coords and cell (``make_coord``, ``make_cell``), the patch wrapper's
stride-1 unfold and centres (``patch_centres``); ``rest`` is the sample's
time outside them (the draws, the crops, the HR residual), and ``stack``
each sample's share of ``loader.stack`` over a batch of 16.
``loader_rate`` times ``--batches`` batches of 16 through ``DataLoader``
(4 worker threads, as the trainers run it) with the residual computed each
way.  Host only: no card is needed.

    python -m bfsr_tpu_torch.profiling.loader_times [--reps 20] \
        [--batches 10]

prints one line per measurement, the host CPU's model and cores, and a
JSON line of all of it.
"""

import argparse
import json
import os
import random
import statistics
import subprocess
import time
from contextlib import ExitStack, contextmanager
from unittest import mock

import numpy as np

from bfsr_tpu_torch import native
from bfsr_tpu_torch.data import wrappers
from bfsr_tpu_torch.data.loader import DataLoader, stack
from bfsr_tpu_torch.data.np_interp import resize_bilinear_np

HR_HW = (1356, 2040)
BATCH, WORKERS, N_BATCHES = 16, 4, 10
INP, SCALE_MAX, PS = 48, 4, 3
# stage -> the functions of data/wrappers timed into it
TIMED = {"pil_resize": ("resize_fn_pil",), "residual": ("residuals",),
         "coords": ("make_coord", "make_cell"),
         "patch_centres": ("patch_centres",)}


def host_cpu():
    """The host CPU as ``lscpu`` names it (model name, vendor, family and
    model numbers) and its logical cores."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    model = ", ".join(f"{k} {fields[k].strip()}" for k in (
        "Model name", "Vendor ID", "CPU family", "Model") if k in fields)
    return model or "unknown (no lscpu)", os.cpu_count()


def hr_images(n=4, hw=HR_HW, seed=0):
    """``n`` smooth random HR images in [0, 1] (a coarse random field,
    bilinear up, plus noise)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coarse = rng.random((hw[0] // 16, hw[1] // 16, 3))
        img = resize_bilinear_np(coarse, hw) + 0.05 * rng.standard_normal(
            (*hw, 3))
        out.append(np.clip(img, 0, 1).astype(np.float32))
    return out


@contextmanager
def residual_path(path):
    """``wrappers.residuals`` (and ``entry``'s import of it) computed by
    ``path``: "native" (the native host library, as every wrapper runs it)
    or "numpy" (its twin ``residuals_np``)."""
    from bfsr_tpu_torch import entry

    fn = {"native": wrappers.residuals, "numpy": wrappers.residuals_np}[path]
    with mock.patch.object(wrappers, "residuals", fn), \
            mock.patch.object(entry, "residuals", fn):
        yield


@contextmanager
def stage_clock(clock):
    """Add the seconds of each call of a ``TIMED`` function of
    ``wrappers``, and of the flip functions ``augment_factory`` makes,
    to ``clock`` by stage.  A timed call inside another counts to the
    outer one only.  Single-threaded."""
    depth = [0]

    def timed(stage, fn):
        def call(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                clock[stage] = (clock.get(stage, 0.0) + time.perf_counter()
                                - t0)
                depth[0] -= 1
        return call

    augment_factory = wrappers.augment_factory
    with ExitStack() as stack:
        for stage, names in TIMED.items():
            for name in names:
                stack.enter_context(mock.patch.object(
                    wrappers, name, timed(stage, getattr(wrappers, name))))
        stack.enter_context(mock.patch.object(
            wrappers, "augment_factory",
            lambda augment: timed("flips", augment_factory(augment))))
        yield


def crop_wrapper(images, patch, inp=INP):
    """The pixel (or, with ``patch``, the patch) trainer's crop wrapper
    over ``images``, flips on."""
    cls = (wrappers.SRImplicitDownsampledFastCropPatch if patch
           else wrappers.SRImplicitDownsampledFastCrop)
    return cls(images, inp_size=inp, scale_max=SCALE_MAX, augment=True)


def stage_split(images, patch, reps=20, seed=0, inp=INP):
    """Median host ms of each stage of one sample of the wrapper's own
    ``__getitem__`` (``reps`` batches of ``BATCH`` samples; ``stack`` a
    sample's share of its batch's), and of the whole sample."""
    random.seed(seed)
    data = crop_wrapper(images, patch, inp)
    per_batch = []
    for r in range(reps):
        clock = {}
        with stage_clock(clock):
            t0 = time.perf_counter()
            items = [data[(r * BATCH + i) % len(data)] for i in range(BATCH)]
            clock["rest"] = time.perf_counter() - t0 - sum(clock.values())
        t0 = time.perf_counter()
        stack(items)
        clock["stack"] = time.perf_counter() - t0
        per_batch.append(clock)
    med = {k: 1e3 * statistics.median(c[k] for c in per_batch) / BATCH
           for k in per_batch[0]}
    med["sample"] = sum(med.values())
    return med


def loader_rate(images, patch, n_batches=N_BATCHES, seed=0):
    """Batches/s of ``n_batches`` batches of ``BATCH`` through the
    trainer's wrapper and ``DataLoader`` (``WORKERS`` threads), and the
    seconds they took."""
    data = crop_wrapper([images[i % len(images)]
                         for i in range(BATCH * n_batches)], patch)
    random.seed(seed)
    loader = DataLoader(data, BATCH, shuffle=True, num_workers=WORKERS,
                        seed=seed)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    wall = time.perf_counter() - t0
    return n / wall, wall


def run(reps=20, n_batches=N_BATCHES, log=print):
    """Every measurement above, each logged; returns them as a dict."""
    native.library()
    model, cores = host_cpu()
    log(f"loader times: host CPU {model!r}, {cores} logical cores; native "
        f"library built and loaded in {native.build_seconds:.2f} s")
    images = hr_images()
    out = {"cpu": model, "cores": cores, "stages": {}, "loader": {}}
    for patch in (False, True):
        trainer = "patch" if patch else "pixel"
        for path in ("native", "numpy"):
            tag = "native" if path == "native" else "numpy twin"
            with residual_path(path):
                med = stage_split(images, patch, reps)
                rate, wall = loader_rate(images, patch, n_batches)
            out["stages"][f"{trainer} {tag}"] = med
            out["loader"][f"{trainer} {tag}"] = rate
            log(f"loader times {trainer} trainer, residual {tag}: one sample "
                + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
                + f" ms; DataLoader ({WORKERS} threads) {n_batches} batches "
                f"of {BATCH} in {wall:.3f} s, {rate:.3f} batches/s")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--batches", type=int, default=N_BATCHES)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.reps, args.batches)), flush=True)


if __name__ == "__main__":
    main()
