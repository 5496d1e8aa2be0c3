"""How far the Swin prior trainer's step strays between its kernel path and
its twin path, beside the twin path's own spread, over several batches.

``chip_smoke.py`` phase 15 (B) holds one step of the flagship LINF with the
``swin_latent`` prior (stochastic depth from one generator state) to the
twin path's spread: each gradient tensor's relative L2 error against the
twin path's, and all of them as one vector, within ``limit(s)`` = min(0.5,
max(1e-3, 2 s)), s the twin path's own error with ``gt_lr_up`` scaled by
1 + 1e-7 and by 1 - 1e-7, the larger.  This script takes that step on the
batches of ``--seeds`` (``entry.example_train_batch``, B 16 of 48^2 LR),
each made with its residual from the native host library and from its
numpy twin (``loader_times.residual_path``), and prints for each: the
kernel path's worst tensor and whole-vector error, the twin's spread under
each sign alone, and whether the step passes under the one-sided limit
(+1e-7 alone) and the two-sided one.  Then one JSON line of all of it.

    python -m bfsr_tpu_torch.profiling.step_spread [--seeds 0 1 2 3 4 5 6 7]

It needs one card (~2 min with the kernels' build) and prints the card's
name and power limit first.
"""

import argparse
import json
import subprocess
import time

import torch

from bfsr_tpu_torch.entry import (build_swin_prior, example_train_batch,
                                  he_normal_vgg)
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.pipelines.linf_train import make_train_step
from bfsr_tpu_torch.profiling.loader_times import residual_path
from bfsr_tpu_torch.train.optim import make_optimizer

NUDGE, FACTOR, FLOOR, CAP = 1e-7, 2.0, 1e-3, 0.5
BATCH, INP, SCALE_MAX = 16, 48, 4


def limit(spread):
    return min(CAP, max(FLOOR, FACTOR * spread))


def rel_l2(grads, ref):
    """(worst tensor's relative L2 error and its name, all of ``grads`` as
    one vector's) against ``ref``."""
    per = {k: float((g - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
           for k, g in grads.items()}
    worst = max(per, key=per.get)
    g = torch.cat([v.flatten() for v in grads.values()])
    r = torch.cat([ref[k].flatten() for k in grads])
    return per[worst], worst, float((g - r).norm() / r.norm())


def step_errors(linf, prior, vgg, batch):
    """The kernel path's errors and the twin's spread under each sign of
    the nudge, each step from one generator state."""
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = gen.get_state()
    steps = {k: make_train_step(linf, prior, vgg, opt, kernels=k,
                                generator=gen) for k in (True, False)}

    def grads(kernels, scale=1.0):
        gen.set_state(state)
        b = dict(batch, gt_lr_up=batch["gt_lr_up"] * scale)
        return steps[kernels].loss_and_grads(b)[1]

    kernel, ref = grads(True), grads(False)
    out = {"kernel": rel_l2(kernel, ref)}
    for sign, tag in ((1, "plus"), (-1, "minus")):
        out[tag] = rel_l2(grads(False, 1 + sign * NUDGE), ref)
    return out


def verdicts(e):
    """Each rule's (tensor limit, vector limit, pass)."""
    out = {}
    for rule, signs in (("one-sided", ("plus",)),
                        ("two-sided", ("plus", "minus"))):
        tol = limit(max(e[s][0] for s in signs))
        tol_all = limit(max(e[s][2] for s in signs))
        out[rule] = (tol, tol_all, e["kernel"][0] <= tol
                     and e["kernel"][2] <= tol_all)
    return out


def run(seeds, log=print):
    """Each row above, logged; returns them as a list of dicts."""
    linf, prior = build_swin_prior("cuda", seed=0)
    prior = prior.train()
    vgg = he_normal_vgg("cuda", seed=0)
    rows = []
    for path in ("native", "numpy"):
        for seed in seeds:
            t0 = time.perf_counter()
            with residual_path(path):
                batch = example_train_batch("cuda", seed, BATCH, INP,
                                            SCALE_MAX)
            e = step_errors(linf, prior, vgg, batch)
            v = verdicts(e)
            rows.append({"residual": path, "seed": seed, **e, **v})
            log(f"step spread swin residual {path} seed {seed}: kernel "
                f"worst {e['kernel'][0]:.3e} ({e['kernel'][1]}), all "
                f"{e['kernel'][2]:.3e}; twin x(1+{NUDGE:g}) worst "
                f"{e['plus'][0]:.3e} ({e['plus'][1]}), all "
                f"{e['plus'][2]:.3e}; x(1-{NUDGE:g}) worst "
                f"{e['minus'][0]:.3e} ({e['minus'][1]}), all "
                f"{e['minus'][2]:.3e}; " + "; ".join(
                    f"{r} limit {t:.3e} / all {ta:.3e}: "
                    f"{'pass' if ok else 'FAIL'}"
                    for r, (t, ta, ok) in v.items())
                + f" ({time.perf_counter() - t0:.1f} s)")
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=list(range(8)))
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda.library()
    print(json.dumps(run(args.seeds)), flush=True)


if __name__ == "__main__":
    main()
