"""SRFlow's ``validate`` before and after the base trainer's first steps,
on the kernel path and on the twin path: whether a sample at heat > 0
stays finite on each.

    python -m bfsr_tpu_torch.profiling.validate_order_probe [--out probe.jsonl]

At 8x and at 16x, builds the flagship SRFlowNet at that scale
(``entry.build_srflow_x8`` / ``build_srflow_x16``: RRDB 64 x 23, K 16,
L 4, hidden 64, random weights from seed 0) on the card, primes its
actnorms on a synthetic batch of 12 x 160^2 GT, and runs ``validate`` on
2 pairs of 160^2 at heats (0, 0.5, 0.75, 1) x 3 samples on both paths
(one JSON line, ``when: primed``).  Then, as ``chip_smoke.py`` times
them, 4 frozen-form steps and 4 live-form steps, each form with a fresh
Adam at the rate and schedule of ``configs/srflow_df2k_{8x,16x}.yml``
(OPT), and ``validate`` again (``when: after_steps``).  Each line gives
each path's NLL, each sample's share of finite pixels on each path, and
the largest difference between the paths over the pixels finite on
both.
"""

import argparse
import json
from pathlib import Path

import torch

from bfsr_tpu_torch import entry
from bfsr_tpu_torch.cli.srflow_train import make_schedule
from bfsr_tpu_torch.pipelines.srflow_eval import validate
from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step
from bfsr_tpu_torch.train.optim import lr_scheduler, make_optimizer

BATCH, GT, PAIRS, SAMPLES = 12, 160, 2, 3
HEATS = (0.0, 0.5, 0.75, 1.0)
STEPS = 4
OPT = {"lr_G": 2.5e-4, "beta1": 0.9, "beta2": 0.99,
       "lr_scheme": "MultiStepLR", "warmup_iter": -1,
       "lr_steps_rel": [0.5, 0.75, 0.9, 0.95], "lr_gamma": 0.5,
       "niter": 70000}
BUILD = {8: entry.build_srflow_x8, 16: entry.build_srflow_x16}


def _step(model, freeze):
    opt = make_optimizer({"name": "adam", "args": {
        "lr": OPT["lr_G"], "betas": (OPT["beta1"], OPT["beta2"])}},
        model.parameters())
    sched = lr_scheduler(opt, make_schedule(OPT, OPT["niter"], OPT["lr_G"]),
                         OPT["lr_G"])
    return make_srflow_train_step(
        model, opt, 1.0, 0.0, rrdb_unfreeze_step=None if freeze else 0,
        freeze_rrdb=freeze, scheduler=sched)


def _validate_both(model, val):
    nll, kern = validate(model, val, HEATS, SAMPLES)
    ref_nll, twin = validate(model, val, HEATS, SAMPLES, kernels=False)
    rows = []
    for key in kern:
        k, t = kern[key], twin[key]
        both = torch.isfinite(k) & torch.isfinite(t)
        rows.append({
            "heat": key[0], "sample": key[1],
            "kernel_finite": float(torch.isfinite(k).float().mean()),
            "twin_finite": float(torch.isfinite(t).float().mean()),
            "max_abs_err_where_both_finite":
                float((k - t)[both].abs().max()) if both.any() else None})
    return {"nll_kernel": nll, "nll_twin": ref_nll, "samples": rows}


def run(dev):
    for scale in (8, 16):
        model = BUILD[scale](dev, seed=0)
        batch = entry.example_srflow_train_batch(dev, 160, BATCH, GT, scale)
        val = [entry.example_srflow_train_batch(dev, 50, PAIRS, GT, scale)]
        model.prime_actnorms(batch["GT"], batch["LQ"])
        yield {"scale": scale, "when": "primed", **_validate_both(model, val)}
        losses = {}
        for form in ("frozen", "live"):
            step = _step(model, form == "frozen")
            losses[form] = [float(step(batch)["loss"]) for _ in range(STEPS)]
        yield {"scale": scale, "when": "after_steps", "step_losses": losses,
               **_validate_both(model, val)}
        del model
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out) if args.out else None
    for line in run(torch.device("cuda")):
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
