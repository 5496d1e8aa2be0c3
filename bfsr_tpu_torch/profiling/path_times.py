"""Per-image times of the port's flagship predicts, to compare two trees.

Times LINF-LP (LR 128^2 -> HR 512^2, ``high``, ``mixed`` and
``default``), the
LINF-LP patch model (LR 128^2, 172^2 centres -> 516^2) and SRFlow-LP
(128^2 -> 512^2, ``high``, ``mixed`` and ``default``) on the card:
random weights from seed 0, 2 warm-ups, then ``--blocks`` blocks of ``--per-block`` predicts each, host clock around
synchronised work.  Prints one JSON line with every block's ms per image.

It uses only entry points the port has had since SRFlow-LP took
``default``, so the same file times an older checkout of the port:

    PYTHONPATH=<checkout> python bfsr_tpu_torch/profiling/path_times.py
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bfsr_tpu_torch.entry import (build_flagship, build_linf_patch,
                                  build_srflow_lp, example_inputs,
                                  example_patch_inputs)
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor


def block_times(fn, blocks, per_block):
    """ms per call of each block, after 2 warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(per_block):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / per_block)
    return out


def in_mode(mode, fn):
    def run():
        saved = fnn.precision_mode()
        fnn.set_default_precision(mode)
        try:
            return fn()
        finally:
            fnn.set_default_precision(saved)
    return run


def run(blocks=5, per_block=5):
    dev = torch.device("cuda")
    res = {}
    model, prior = build_flagship(dev, seed=0)
    inputs = example_inputs(dev, (128, 128), (512, 512), seed=0)
    pred = LINFPredictor(model, prior)
    res["linf 512"] = block_times(lambda: pred.predict(*inputs), blocks,
                                  per_block)
    for mode in ("mixed", "default"):
        res[f"linf 512 {mode}"] = block_times(
            in_mode(mode, lambda: pred.predict(*inputs)), blocks, per_block)
    del model, prior, pred, inputs
    pmodel, pprior = build_linf_patch(dev, seed=0)
    pinputs = example_patch_inputs(dev, (128, 128), (172, 172), seed=0)
    ppred = LINFPredictor(pmodel, pprior)
    res["patch 516"] = block_times(lambda: ppred.predict(*pinputs), blocks,
                                   per_block)
    del pmodel, pprior, ppred, pinputs
    smodel, sprior = build_srflow_lp(dev, seed=0)
    lr = torch.as_tensor(np.random.default_rng(0).random((128, 128, 3)),
                         dtype=torch.float32, device=dev)
    spred = SRFlowLPPredictor(smodel, sprior)
    for mode in ("high", "mixed", "default"):
        res[f"srflow 512 {mode}"] = block_times(
            in_mode(mode, lambda: spred.predict(lr)), blocks, per_block)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--per-block", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    res = run(args.blocks, args.per_block)
    print(json.dumps({"label": args.label, "card": smi, "ms": res,
                      "median_ms": {k: statistics.median(v)
                                    for k, v in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
