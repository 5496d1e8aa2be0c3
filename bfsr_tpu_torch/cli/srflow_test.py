"""SRFlow-LP evaluation CLI: the counterpart of ``srflow_test.py``.

    python -m bfsr_tpu_torch.cli.srflow_test <conf.yml> \\
        [--limit N] [--lpips_weights PATH | --no_lpips] \\
        [--pad_multiple M] [--warmup] [--heat T] [--seed N] \\
        [--precision high|highest|mixed|default] [--device cuda|cpu]

It reads the reference's conf schema: ``dataroot_LR`` / ``dataroot_GT``
(folders of PNGs, paired in natural order), ``scale``, ``network_G``,
``model_path`` and ``prior_model`` / ``prior_model_path`` (a torch file of
the reference's ``state_dict``, a checkpoint of ``cli/srflow_train.py``,
or a JAX ``.ckpt``; random weights, loudly, where a path is missing).
The input folders are checked before the models are built.  Per image it
writes the SR PNG under ``results/SRFlow-LP/`` and prints PSNR, SSIM,
LPIPS (``utils/measure.py``) and the LR-consistency PSNR (the SR
downsampled by ``imresize`` against the LR, on uint8); the rows go to
``results/SRFlow-LP/measure_full.csv``, rewritten crash-safe after each
image, and the means to a ``Mean:`` line.  LPIPS needs weights
(``--lpips_weights``) unless ``--no_lpips``.  ``--pad_multiple`` pads the
LR to that multiple (2 at least) and crops the SR back; ``--warmup``
predicts each padded LR shape once first, its size read from the PNG
headers.

A conf without ``prior_model`` (plain SRFlow, such as the 8x model of
``bfsr_tpu_torch/configs/srflow_df2k_8x.yml``, whose L 4 flow the
two-branch prior does not read) is served by the sampler instead:
``pipelines/srflow_eval.py:sample_sr`` at temperature ``--heat`` (0 by
default), image i drawn from a generator seeded with ``--seed`` + i, each
LR padded to the multiple its flow decodes (``lr_multiple``;
``--pad_multiple`` is the predictor's), the rows under
``results/SRFlow/``.  The JAX CLI has no such mode: it needs a
prior.
"""

import argparse
import csv
import glob
import os
import time

import numpy as np
import torch

import bfsr_tpu_torch.models  # noqa: F401  (registers)
from bfsr_tpu_torch.cli.srflow_train import load_prior, load_srflow
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.imresize import imresize
from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                  lr_multiple, sample_sr)
from bfsr_tpu_torch.utils.measure import Measure, natsorted, psnr_uint8

FIELDS = ("conf", "name", "PSNR", "SSIM", "LPIPS", "LRC PSNR")


def read_rgb(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def write_rows(path, rows):
    """``rows`` as a CSV at ``path``, written to a temporary file and
    renamed."""
    tmp = path + "_"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(FIELDS))
        writer.writeheader()
        writer.writerows(rows)
    os.replace(tmp, path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("conf")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--no_lpips", action="store_true",
                        help="skip the LPIPS metric (otherwise weights are "
                             "required)")
    parser.add_argument("--pad_multiple", type=int, default=2,
                        help="pad each LR to this multiple (2 at least); "
                             "the SR is cropped back")
    parser.add_argument("--warmup", action="store_true",
                        help="predict each padded LR shape once before the "
                             "sweep (shapes read from the PNG headers)")
    parser.add_argument("--heat", type=float, default=0.0,
                        help="without a prior_model: the sampling "
                             "temperature")
    parser.add_argument("--seed", type=int, default=0,
                        help="without a prior_model: image i's seed is "
                             "seed + i")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest", "mixed"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.precision:
        fnn.set_default_precision(args.precision)
    import yaml
    from PIL import Image

    with open(args.conf) as f:
        opt = yaml.safe_load(f)
    device = torch.device(args.device)

    lpips_model = None
    if args.lpips_weights:
        from bfsr_tpu_torch.models.lpips import load_lpips

        lpips_model = load_lpips(args.lpips_weights, device)
    elif not args.no_lpips:
        raise SystemExit(
            "LPIPS (the paper's headline metric) needs weights: pass "
            "--lpips_weights (the lpips package's alexnet state_dict, or a "
            "converted .ckpt), or --no_lpips to skip it.")
    measure = Measure(lpips_model)

    # the inputs first: a model build can take minutes
    lr_paths = natsorted(glob.glob(os.path.join(opt["dataroot_LR"], "*.png")))
    hr_paths = natsorted(glob.glob(os.path.join(opt["dataroot_GT"], "*.png")))
    if not lr_paths or not hr_paths:
        raise SystemExit(
            f"no .png images found (dataroot_LR={opt['dataroot_LR']!r}: "
            f"{len(lr_paths)} files, dataroot_GT={opt['dataroot_GT']!r}: "
            f"{len(hr_paths)} files) - check the conf paths")
    if args.limit:
        lr_paths, hr_paths = lr_paths[:args.limit], hr_paths[:args.limit]

    model = load_srflow(opt, device)
    if "prior_model" in opt:
        prior = load_prior(opt, device, train=False)
        predictor = SRFlowLPPredictor(model, prior,
                                      pad_multiple=args.pad_multiple)
        m, test_dir = predictor.pad_multiple, os.path.join("results",
                                                           "SRFlow-LP")

        def predict(lr01, idx):
            return predictor.predict(lr01)
    else:
        m, test_dir = lr_multiple(model), os.path.join("results", "SRFlow")

        def predict(lr01, idx):
            return sample_sr(model, lr01, args.heat, args.seed + idx)
    if args.warmup:
        for shape in dict.fromkeys(
                (-(-h // m) * m, -(-w // m) * m)
                for w, h in (Image.open(p).size for p in lr_paths)):
            t0 = time.perf_counter()
            predict(np.zeros((*shape, 3), np.float32), 0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"warmup: LR {shape[0]}x{shape[1]} in "
                  f"{time.perf_counter() - t0:.1f}s")

    os.makedirs(test_dir, exist_ok=True)
    csv_partial = os.path.join(test_dir, "measure_full.csv_")
    rows, scale = [], opt["scale"]
    for idx, (lp, hp) in enumerate(zip(lr_paths, hr_paths)):
        lr = read_rgb(lp)
        hr = read_rgb(hp)
        sr01 = predict(lr.astype(np.float32) / 255.0, idx)
        sr = np.round(sr01.cpu().numpy() * 255.0).astype(np.uint8)
        Image.fromarray(sr).save(os.path.join(test_dir, f"{idx:06d}.png"))
        p, s, lp_ = measure.measure(sr, hr)
        lrc = psnr_uint8(lr, imresize(sr, scale=1.0 / scale))
        row = dict(zip(FIELDS, (os.path.basename(args.conf), idx, p, s, lp_,
                                lrc)))
        rows.append(row)
        print(", ".join(f"{k}: {v:0.4f}" if isinstance(v, float)
                        else f"{k}: {v}" for k, v in row.items()),
              flush=True)
        write_rows(csv_partial, rows)
    csv_final = os.path.join(test_dir, "measure_full.csv")
    os.replace(csv_partial, csv_final)
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("PSNR", "SSIM", "LPIPS", "LRC PSNR")}
    print("Mean: " + ", ".join(f"{k}: {v:0.4f}" for k, v in mean.items()))
    print(f"Results in: {csv_final}")
    return rows


if __name__ == "__main__":
    main()
