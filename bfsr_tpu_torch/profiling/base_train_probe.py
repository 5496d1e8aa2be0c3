"""The SRFlow base trainer's first steps from a random, primed flagship
model: how its NLL moves under the conf's Adam, and what moves it.

    python -m bfsr_tpu_torch.profiling.base_train_probe [--steps 20] \\
        [--out probe.jsonl]

Builds ``srflow_specs()[0]`` (RRDB 64 x 23, K 16, L 3, hidden 64) with
``reset_parameters(seeded(0))`` on the card, primes its actnorms on the
first of 4 synthetic batches of 12 x 160^2 GT (as ``chip_smoke.py`` phase
14 does), and prints one JSON line per case:

* ``primed``: the RMS of each level's conditioning map (the RRDB's taps
  the flow reads) on that batch, and the NLL of each of the 4 batches
  (fixed noise) at the primed weights, before any step;
* per variant, each from the primed weights and a fresh Adam: the NLL of
  batch 0 with fixed noise before any step and after each of the first
  three, the loss of each of ``--steps`` frozen-form steps (the 4 batches
  in turn, each with its own fixed noise), and after the first step the
  largest change of any parameter and the RMS change of each level's
  records (``precompute_ft``) relative to their RMS.  The variants: ``conf``
  (Adam 2.5e-4, betas (0.9, 0.99), every parameter), ``lr/10`` (2.5e-5),
  and ``cond_convs_held`` (2.5e-4, the first conv of both coupling towers,
  the only weights that read the raw conditioning, left out of the
  optimizer).
"""

import argparse
import json
import math
from pathlib import Path

import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.entry import example_srflow_train_batch, srflow_specs
from bfsr_tpu_torch.models.base import seeded
from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step
from bfsr_tpu_torch.train.optim import make_optimizer

BATCH, GT = 12, 160
VARIANTS = {"conf": (2.5e-4, False), "lr/10": (2.5e-5, False),
            "cond_convs_held": (2.5e-4, True)}


def _cond_conv(name):
    return name.endswith(("affine.fFeatures.0.weight",
                          "affine.fAffine.0.weight"))


def _records(model, lq):
    with torch.no_grad():
        return model.precompute_ft(model.rrdb_preprocess(lq))


def _nll(model, batch, noise):
    with torch.no_grad():
        cache = model.precompute_ft(model.rrdb_preprocess(batch["LQ"]))
        return float(model.normal_flow_nll(batch["GT"], cache,
                                           noise)[1].mean())


def _record_change(model, before, after):
    """{level: RMS(after - before) / RMS(before)} over the levels' records."""
    out = {}
    for e, b, a in zip(model.plan, before, after):
        if b is None:
            continue
        lvl = str(e["level"])
        d, r = out.setdefault(lvl, [0.0, 0.0])
        out[lvl] = [d + float((a - b).square().sum()),
                    r + float(b.square().sum())]
    return {k: math.sqrt(d / r) for k, (d, r) in out.items()}


def run(steps, dev):
    model = registry.make(srflow_specs()[0])
    model.reset_parameters(seeded(0))
    model = model.to(dev).freeze()
    batches = [example_srflow_train_batch(dev, 40 + s, BATCH, GT)
               for s in range(4)]
    model.prime_actnorms(batches[0]["GT"], batches[0]["LQ"])
    gen = torch.Generator(device=dev).manual_seed(0)
    noises = [(torch.rand(b["GT"].shape, generator=gen, device=dev) - 0.5)
              / model.quant for b in batches]
    with torch.no_grad():
        conds = model._conds(model.rrdb_preprocess(batches[0]["LQ"]))
    yield {"case": "primed",
           "conditioning_rms": {str(k): float(v.square().mean().sqrt())
                                for k, v in conds.items()},
           "nll_each_batch": [_nll(model, b, n)
                              for b, n in zip(batches, noises)]}
    primed = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, (lr, held) in VARIANTS.items():
        model.load_state_dict(primed)
        model.freeze()
        params = [p for n, p in model.named_parameters()
                  if not (held and _cond_conv(n))]
        opt = make_optimizer({"name": "adam", "args": {
            "lr": lr, "betas": (0.9, 0.99)}}, params)
        step = make_srflow_train_step(model, opt, 1.0, 0.0,
                                      freeze_rrdb=True)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        recs0 = _records(model, batches[0]["LQ"])
        fixed = [_nll(model, batches[0], noises[0])]
        losses = []
        for i in range(steps):
            losses.append(step(batches[i % 4], i, noises[i % 4])["loss"])
            if i == 0:
                moved = max(float((p.detach() - before[n]).abs().max())
                            for n, p in model.named_parameters())
                recs1 = _records(model, batches[0]["LQ"])
                rec_change = _record_change(model, recs0, recs1)
                del recs0, recs1
            if i < 3:
                fixed.append(_nll(model, batches[0], noises[0]))
        yield {"case": name, "lr": lr, "cond_convs_held": held,
               "params_trained": sum(p.numel() for p in params),
               "nll_batch0_fixed_noise": fixed, "step_losses": losses,
               "largest_param_change_step1": moved,
               "records_rel_rms_change_step1": rec_change}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out) if args.out else None
    for line in run(args.steps, torch.device(args.device)):
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
