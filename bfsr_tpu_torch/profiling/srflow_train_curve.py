"""SRFlow NLL learning curve at full size.

Trains the full SRFlowNet (RRDB nf 64, nb 23, gc 32; K 16, L 3, hidden
64, ``entry.srflow_specs``) from the reference's initialisation (the
RRDB from seed ``SEED``, the flow's tails and actnorms zero:
``reset_parameters(live=False)``) at the reference training shape (batch
12 of 160^2 GT, quantisation noise) with the RRDB frozen
(``freeze_rrdb=True``: its dense-block convs on K3, 345 launches a step)
and Adam at 2.5e-4 behind ``clip_by_global_norm(10)``, on one fixed batch
of the learnable task of ``learnable_task`` (GT = bilinear x4 of a smooth
LQ plus a checker of period 4, amp 0.08).  The counterpart of the JAX
package's ``profiling/srflow_train_curve.py``.

    python -m bfsr_tpu_torch.profiling.srflow_train_curve [--steps 400] \\
        [--device cuda]

Prints the NLL (bits/dim) at the JAX script's marks, ms a step, and, on
2 unseen pairs at the trained and the initial weights, the heat-0 decode
PSNR (the decode on K5's reverse, 48 launches, after ``freeze()``) and
the NLL, each with the card's name and power limit.
"""

import argparse
import copy

import numpy as np
import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.entry import srflow_specs
from bfsr_tpu_torch.models.base import seeded
from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step
from bfsr_tpu_torch.profiling import learnable_task as task
from bfsr_tpu_torch.train.optim import clip_by_global_norm

AT = (0, 1, 2, 5, 10, 20, 50, 100, 200, 300)
FIRST, LAST = 5, 10
BATCH, GT, SCALE = 12, 160, 4
PERIOD, AMP, DIV, LR, CLIP = 4, 0.08, 4, 2.5e-4, 10.0
SEED, HELD_OUT_SEED, N_HELD_OUT = 0, 99, 2


def task_pair(rng, n, gt=GT):
    """The curve's pairs: LQ of gt / 4 from ``rng``, GT their x4 plus the
    checker."""
    return task.srflow_pair(rng, n, (gt // SCALE, gt // SCALE), SCALE, AMP,
                            PERIOD, DIV)


@torch.no_grad()
def heat0_psnr(model, lq, gt, kernels=True):
    """PSNR of the heat-0 decode (a zero final latent, zero split epses)
    of lq against gt, clipped to [0, 1]; ``freeze()`` first (the trained
    weights' K5 packs)."""
    model.freeze()
    sr = model.get_sr(lq, heat=0.0, kernels=kernels)
    return task.psnr(torch.clamp(sr, 0.0, 1.0), gt)


@torch.no_grad()
def nll(model, lq, gt, noise):
    """The mean NLL (bits/dim) of gt + ``noise`` on the log-det encode."""
    cache = model.precompute_ft(model.rrdb_preprocess(lq))
    return float(model.normal_flow_nll(gt, cache, noise)[1].mean())


def run(steps=400, device="cuda", tiny=False, log=print):
    """Train for ``steps`` steps on one fixed batch and report (``tiny``:
    the CPU test size, ``entry.srflow_specs(tiny=True)``).  Returns
    {'losses', 'ms', 'launches' (every step's), 'held_out': {'psnr' (heat
    0), 'nll' (on noise drawn from ``SEED``): {'init', 'trained'}}}."""
    device = torch.device(device)
    where = task.card(device)
    model = registry.make(srflow_specs(tiny)[0])
    model.reset_parameters(seeded(SEED), live=False)
    model = model.to(device).freeze()
    init = copy.deepcopy(model).freeze()
    opt = clip_by_global_norm(torch.optim.Adam(model.parameters(), lr=LR),
                              CLIP)
    gen = torch.Generator(device=device).manual_seed(SEED)
    step = make_srflow_train_step(model, opt, 1.0, 0.0, freeze_rrdb=True,
                                  generator=gen)
    batch = to_device(task_pair(np.random.default_rng(SEED), BATCH), device,
                      ("GT", "LQ"))
    losses, ms, launches = task.train(step, lambda i: batch, steps)
    held = to_device(task_pair(np.random.default_rng(HELD_OUT_SEED),
                               N_HELD_OUT), device, ("GT", "LQ"))
    noise = (torch.rand(held["GT"].shape, generator=gen, device=device)
             - 0.5) / model.quant
    models = (("init", init), ("trained", model))
    curve = {"losses": losses, "ms": ms, "launches": launches, "held_out": {
        "nll": {k: nll(m, held["LQ"], held["GT"], noise) for k, m in models},
        "psnr": {k: heat0_psnr(m, held["LQ"], held["GT"]) for k, m in models}}}
    task.report(f"srflow nll curve (B {BATCH}, GT {GT}^2, bits/dim)", curve,
                AT, FIRST, LAST, where, log)
    return curve


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.steps, args.device)


if __name__ == "__main__":
    main()
