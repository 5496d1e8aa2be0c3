"""SRFlow-LP latent-module (prior) learning curve at full size.

Trains the two-branch UNet prior (depth 3, dim 64, from seed ``SEED``) against
the frozen SRFlowNet (RRDB nf 64, nb 23; K 16, L 3, hidden 64: the
reference's initialisation, its actnorms primed from the first batch, as
a trained flow's epses are ~N(0, 1) a channel) at the reference training
shape (batch 12 of 160^2 GT), with the eps L1 plus twice the heat-0
decode's L1 to GT, and Adam at 2e-4.  The task is ``learnable_task``'s
(GT = bilinear x4 of a smooth LQ plus a checker of period 4, amp 0.12),
with FRESH pairs every step, drawn on the device from a ``torch.
Generator`` seeded with ``SEED``: the prior must learn the rule, not the
images.  The counterpart of the JAX package's ``profiling/
prior_train_curve.py``.

    python -m bfsr_tpu_torch.profiling.prior_train_curve [--steps 400] \\
        [--device cuda]

On the card a step launches K3 345 times (the frozen RRDB), K5's forward
96 times (both encodes) and its reverse 48 (the image loss's decode).
Prints the loss at the JAX script's marks, ms a step (the pairs' making
included), and the held-out decode PSNR of 2 unseen pairs through the
evaluation contract (encode LR-up, standardise, prior, decode) for the
trained prior, the init prior and no prior (the raw LR-up epses), each
with the card's name and power limit.
"""

import argparse
import copy

import numpy as np
import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.entry import srflow_specs
from bfsr_tpu_torch.models.base import seeded
from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step)
from bfsr_tpu_torch.profiling import learnable_task as task

AT = (0, 1, 2, 5, 10, 20, 50, 100, 200, 300)
FIRST, LAST = 5, 10
BATCH, GT, SCALE = 12, 160, 4
PERIOD, AMP, DIV, LR = 4, 0.12, 4, 2e-4
EPS_WEIGHT, IMAGE_WEIGHT = 1.0, 2.0
SEED, HELD_OUT_SEED, N_HELD_OUT = 0, 99, 2


TASK = {"scale": SCALE, "amp": AMP, "period": PERIOD, "div": DIV}


@torch.no_grad()
def decode_psnrs(model, priors, lq, gt, kernels=True):
    """Held-out PSNR through the evaluation contract (the JAX
    ``srflow_eval._impl`` data path): encode the bilinear x s of lq,
    standardise each eps over channels, run each prior (eval mode,
    frozen) or none ('no prior': the raw epses, which the flow decodes back
    to lr_up), decode, clip to [0, 1] against gt.  priors: {name: prior or
    None}."""
    s = model.scale
    lr_up = resize_bilinear(lq, (lq.shape[1] * s, lq.shape[2] * s))
    cache = model.precompute_ft(model.rrdb_preprocess(lq, kernels))
    epses = model.normal_flow(lr_up, cache, kernels)
    eps_in = standardize_epses(epses)
    out = {}
    for name, prior in priors.items():
        learned = epses if prior is None else prior(eps_in, kernels=kernels)
        sr = model.reverse_flow(learned, cache, kernels)
        out[name] = task.psnr(torch.clamp(sr, 0.0, 1.0), gt)
    return out


def run(steps=400, device="cuda", tiny=False, log=print):
    """Train for ``steps`` steps on fresh pairs and report (``tiny``: the
    CPU test size, ``entry.srflow_specs(tiny=True)``).  Returns {'losses',
    'ms', 'launches' (every step's), 'held_out': {'psnr': {'no prior',
    'init', 'trained'}}}."""
    device = torch.device(device)
    where = task.card(device)
    flow_spec, prior_spec = srflow_specs(tiny)
    gen = seeded(SEED)
    model = registry.make(flow_spec)
    model.reset_parameters(gen, live=False)
    prior = registry.make(prior_spec)
    prior.reset_parameters(gen)
    model = model.to(device).freeze()
    prior = prior.to(device).eval().freeze()
    init = copy.deepcopy(prior).freeze()
    data = torch.Generator(device=device).manual_seed(SEED)
    lr_hw = (GT // SCALE, GT // SCALE)
    batch0 = task.srflow_pair_t(data, BATCH, lr_hw, **TASK)
    model.prime_actnorms(batch0["GT"], batch0["LQ"])
    opt = torch.optim.Adam(prior.train().parameters(), lr=LR)
    step = make_srflow_prior_train_step(model, prior, opt, EPS_WEIGHT,
                                        IMAGE_WEIGHT)
    losses, ms, launches = task.train(
        step, lambda i: task.srflow_pair_t(data, BATCH, lr_hw, **TASK), steps)
    held = to_device(task.srflow_pair(np.random.default_rng(HELD_OUT_SEED),
                                      N_HELD_OUT, lr_hw, **TASK),
                     device, ("GT", "LQ"))
    psnrs = decode_psnrs(model, {"no prior": None, "init": init,
                                 "trained": prior.eval().freeze()},
                         held["LQ"], held["GT"])
    curve = {"losses": losses, "ms": ms, "launches": launches,
             "held_out": {"psnr": psnrs}}
    task.report(f"srflow-lp prior curve (B {BATCH}, GT {GT}^2, eps L1 + "
                f"{IMAGE_WEIGHT:g} x image L1, fresh pairs)", curve, AT,
                FIRST, LAST, where, log)
    return curve


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.steps, args.device)


if __name__ == "__main__":
    main()
