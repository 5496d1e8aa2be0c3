"""LINF-LP latent-module learning curve at full size.

Trains the flagship's UNet prior (depth 3, dim 64) against the frozen
flagship LINF (``entry.build_flagship``: EDSR-baseline 16x64, flow L 10,
info MLP 256 wide) at the reference training shape (batch 16 of 48^2 LR
crops, x2) on the learnable task of ``learnable_task``: GT is the LR's
bilinear upsample plus a fixed checker of period 3 (amp 0.15 in the
normalised domain); 64 distinct crops, cycled in batches.  The loss is
the latent L1 alone: no VGG weights ship with the repository, and a
random VGG's perceptual term would only add noise.  Adam at 1e-4.  The
counterpart of the JAX package's ``profiling/train_curve.py``.

    python -m bfsr_tpu_torch.profiling.train_curve [--steps 2000] \\
        [--device cuda] [--seed 0]

``--seed`` draws the weights (the frozen LINF's and the prior's) and
leaves the task as it is: the crops stay those of the JAX script
(``default_rng(0)``), so runs at several seeds show how far the result
moves with the random weights alone.

On the card a step launches K3 34 times (the frozen encoder at B 16), K2
once and K1's forward twice (the LR-up and HR residuals); the held-out
decode runs K1's inverse.  Prints the loss at the JAX script's marks, ms
a step, and the held-out PSNR (4 unseen images of the same family) of
the trained prior beside the init prior's and the no-prior inversion of
z_lr, each with the card's name and power limit.
"""

import argparse
import copy

import numpy as np
import torch

from bfsr_tpu_torch.entry import build_flagship
from bfsr_tpu_torch.pipelines.linf_train import make_train_step, to_device
from bfsr_tpu_torch.profiling import learnable_task as task

AT = (0, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 1500)
FIRST, LAST = 5, 20
BATCH, LR_SIZE, SCALE, N_TRAIN = 16, 48, 2, 64
PERIOD, AMP, LR = 3, 0.15, 1e-4
SEED, HELD_OUT_SEED, N_HELD_OUT = 0, 999, 4


@torch.no_grad()
def heldout_psnrs(linf, priors, lr01, pattern, scale, amp, kernels=True):
    """PSNR in the normalised domain of each prior's decode of held-out
    LR images ``lr01`` (numpy (B, h, w, 3)) against their GT (lr_up + amp
    * pattern): z_lr (the LR-up residual's latent) through each prior
    (eval mode, frozen), or through none ('no prior': z_lr inverted as it
    is), then the flow inverse and the bilinear add-back.  priors: {name:
    prior or None}."""
    dev = next(linf.parameters()).device
    data, gt_norm = task.linf_batch(lr01, pattern, scale, amp)
    b = to_device(data, dev)
    inp = (b["inp"] - 0.5) / 0.5
    feat = linf.gen_feat(inp, kernels=kernels)
    _, z_lr = linf.query_log_p(inp, feat, b["coord"], b["cell"],
                               b["gt_lr_up"], kernels=kernels)
    out = {}
    for name, prior in priors.items():
        z = z_lr if prior is None else prior(z_lr, inp, kernels=kernels)
        pred = linf.query_rgb(inp, feat, b["coord"], b["cell"], zmap=z,
                              kernels=kernels)
        out[name] = task.psnr(pred, gt_norm)
    return out


def run(steps=2000, device="cuda", tiny=False, seed=SEED, log=print):
    """Train from the flagship's random weights (from ``seed``; the crops
    from ``SEED`` whatever it is; ``tiny``: the CPU test size,
    ``entry.flagship_specs(tiny=True)``) for ``steps`` steps and report.  Returns {'losses', 'ms', 'launches' (a step's, every
    step), 'held_out': {'psnr': {'no prior', 'init', 'trained'}}}."""
    device = torch.device(device)
    where = task.card(device)
    linf, prior = build_flagship(device, seed, tiny)
    init = copy.deepcopy(prior).freeze()
    prior.train()
    opt = torch.optim.Adam(prior.parameters(), lr=LR)
    step = make_train_step(linf, prior, None, opt, vgg_weight=0.0,
                           latent_weight=1.0)
    pattern = task.checker(LR_SIZE * SCALE, LR_SIZE * SCALE, PERIOD)
    lrs = task.smooth_lr(np.random.default_rng(SEED), N_TRAIN, LR_SIZE,
                         LR_SIZE)
    batches = [to_device(task.linf_batch(lrs[i:i + BATCH], pattern, SCALE,
                                         AMP)[0], device)
               for i in range(0, N_TRAIN, BATCH)]
    eval_lr = task.smooth_lr(np.random.default_rng(HELD_OUT_SEED), N_HELD_OUT,
                             LR_SIZE, LR_SIZE)
    psnrs = heldout_psnrs(linf, {"no prior": None, "init": init}, eval_lr,
                          pattern, SCALE, AMP)
    losses, ms, launches = task.train(
        step, lambda i: batches[i % len(batches)], steps)
    psnrs.update(heldout_psnrs(linf, {"trained": prior.eval().freeze()},
                               eval_lr, pattern, SCALE, AMP))
    curve = {"losses": losses, "ms": ms, "launches": launches,
             "held_out": {"psnr": psnrs}}
    task.report(f"linf latent curve (B {BATCH}, LR {LR_SIZE}^2 x{SCALE}, "
                f"latent L1, weights from seed {seed})", curve, AT, FIRST, LAST, where, log)
    return curve


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="the weights' seed (the crops stay those of seed 0)")
    args = ap.parse_args()
    run(args.steps, args.device, seed=args.seed)


if __name__ == "__main__":
    main()
