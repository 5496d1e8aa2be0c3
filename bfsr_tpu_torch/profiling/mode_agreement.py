"""Agreement of the bf16 serving modes with ``high``.

The counterpart of ``bench.py:run_precision_delta``: the PSNR, on the
[0, 1] scale, between a mode's output and ``high``'s for the same model,
weights and input.  It runs the flagship LINF-LP (``mixed``, ``default``)
and SRFlow-LP (``mixed``, ``default``) kernel paths, random weights from seed 0, inputs
from ``np.random.default_rng(0)``, on any device (the twins on the CPU):

    python -m bfsr_tpu_torch.profiling.mode_agreement --device cpu --lr 32
"""

import argparse
import json
import math
import sys

import numpy as np
import torch

from bfsr_tpu_torch.entry import build_flagship, build_srflow_lp, example_inputs
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor


def agreement_db(out, ref):
    """PSNR of ``out`` against ``ref`` on the [0, 1] scale, in float64."""
    mse = float(((out.double() - ref.double()) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-30))


def in_modes(fn, modes):
    """{mode: fn()} with each mode set in turn; the mode comes back."""
    saved = fnn.precision_mode()
    try:
        out = {}
        for mode in modes:
            fnn.set_default_precision(mode)
            out[mode] = fn()
        return out
    finally:
        fnn.set_default_precision(saved)


def run(device="cuda", lr=128, scale=4):
    """{'linf mixed', 'linf default', 'srflow mixed', 'srflow default'}:
    dB against high."""
    model, prior = build_flagship(device, seed=0)
    inputs = example_inputs(device, (lr, lr), (lr * scale, lr * scale))
    outs = in_modes(lambda: LINFPredictor(model, prior).predict(*inputs),
                    ("high", "mixed", "default"))
    res = {f"linf {m}": agreement_db(outs[m], outs["high"])
           for m in ("mixed", "default")}
    smodel, sprior = build_srflow_lp(device, seed=0)
    img = torch.as_tensor(np.random.default_rng(0).random((lr, lr, 3)),
                          dtype=torch.float32, device=device)
    souts = in_modes(lambda: SRFlowLPPredictor(smodel, sprior).predict(img),
                     ("high", "mixed", "default"))
    for m in ("mixed", "default"):
        res[f"srflow {m}"] = agreement_db(souts[m], souts["high"])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lr", type=int, default=128, help="LR side (x4 SR)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mode_agreement: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"device": args.device, "lr": args.lr,
                      "agreement_db": run(args.device, args.lr)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
