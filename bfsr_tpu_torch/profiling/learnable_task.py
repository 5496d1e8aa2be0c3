"""Synthetic but learnable training tasks: the data of the convergence
tests (``tests/test_torch_convergence.py``) and of the three full-size
learning curves (``train_curve.py``, ``srflow_train_curve.py``,
``prior_train_curve.py``).

GT is the bilinear blow-up of a smooth LR field plus a FIXED
high-frequency checker pattern: the trainable part must learn to
reproduce the pattern, so its loss can fall far and a held-out image of
the same family shows whether it learned the rule.  The counterpart of
the JAX package's ``tests/test_convergence.py:36-84`` helpers and of its
``profiling/*train_curve.py`` helpers.

The numpy functions draw from a ``np.random.Generator``.  ``srflow_pair_t``
makes the SRFlow pair on any device from a ``torch.Generator`` (the prior
curve's fresh pairs, one batch a step, on the card); given the same coarse
field it computes what ``srflow_pair`` computes.

The curves' loop and report (``train``, ``report``) are shared by the
three curve scripts.
"""

import time

import numpy as np
import torch

from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
from bfsr_tpu_torch.ops.interp import grid_sample_bilinear, resize_bilinear
from bfsr_tpu_torch.utils.coords import make_cell, make_coord


def psnr(pred, gt):
    """PSNR in dB of two arrays or tensors in [0, 1] (float64 mean)."""
    a, b = (np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                       np.float64) for x in (pred, gt))
    return float(-10.0 * np.log10(np.mean((a - b) ** 2) + 1e-12))


def coarse_shape(n, h, w, div):
    """The coarse field's shape behind ``n`` smooth LR fields of h x w."""
    return (n, max(2, h // div), max(2, w // div), 3)


def smooth_from_coarse(coarse, h, w):
    """Smooth LR fields in [0.25, 0.75]: the bilinear blow-up of each coarse
    field (n, ch, cw, 3) to h x w."""
    out = np.stack([resize_bilinear_np(c, (h, w)) for c in coarse])
    return (0.25 + 0.5 * out).astype(np.float32)


def smooth_lr(rng, n, h, w, div=3):
    """``n`` smooth LR fields (n, h, w, 3) from coarse uniform noise of
    about 1/``div`` the size drawn from ``rng``."""
    coarse = rng.random(coarse_shape(n, h, w, div)).astype(np.float32)
    return smooth_from_coarse(coarse, h, w)


def checker(H, W, period=2):
    """The fixed pattern (H, W, 3): +-1 squares of ``period`` pixels, per
    channel x (1, -0.5, 0.25)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pat = (((yy // period) + (xx // period)) % 2).astype(np.float32) * 2 - 1
    return pat[..., None] * np.asarray([1.0, -0.5, 0.25], np.float32)


def linf_batch(lr01, pattern, scale, amp=0.15):
    """A self-consistent LINF train batch on the whole HR grid of
    ``scale`` x the LR: gt = lr_up + amp * pattern in the normalised
    domain, ``gt_pixel`` and ``gt_lr_up`` as the crop wrapper makes them.
    Returns (batch of numpy arrays, gt_norm (B, H, W, 3)).  lr01: (B, h, w,
    3) in [0, 1]; pattern: (H, W, 3)."""
    B, h, w, _ = lr01.shape
    H, W = h * scale, w * scale
    coord_np = make_coord((H, W), flatten=False)
    coord = np.broadcast_to(coord_np[None], (B, H, W, 2))
    inp_norm = (lr01 - 0.5) / 0.5
    # the model adds back the bilinear sample of inp_norm at each query: the
    # same operator makes gt_pixel exactly the flow's target residual
    lr_up = grid_sample_bilinear(torch.from_numpy(inp_norm),
                                 torch.from_numpy(np.ascontiguousarray(coord)),
                                 padding_mode="border").numpy()
    delta = np.broadcast_to(amp * pattern, lr_up.shape).astype(np.float32)
    gt_norm = lr_up + delta
    gt01 = np.clip(gt_norm * 0.5 + 0.5, 0.0, 1.0)
    gt_lr_up = np.empty_like(lr_up)
    for b in range(B):
        down = resize_bilinear_np(lr_up[b], (h, w))
        gt_lr_up[b] = lr_up[b] - resize_bilinear_np(down, (H, W))
    cell = np.broadcast_to(make_cell((H, W))[None], (B, 2))
    return {"inp": lr01, "coord": np.ascontiguousarray(coord),
            "cell": np.ascontiguousarray(cell), "gt": gt01,
            "gt_pixel": delta, "gt_lr_up": gt_lr_up}, gt_norm


def pair_from_lq(lq, scale, amp, period):
    """{'GT', 'LQ'}: GT = clip(bilinear x ``scale`` of LQ + amp * checker)."""
    n, h, w, _ = lq.shape
    H, W = h * scale, w * scale
    up = np.stack([resize_bilinear_np(x, (H, W)) for x in lq])
    gt = np.clip(up + amp * checker(H, W, period), 0.0, 1.0)
    return {"GT": gt.astype(np.float32), "LQ": lq}


def srflow_pair(rng, n, lr_hw, scale=4, amp=0.1, period=2, div=3):
    """``n`` SRFlow pairs (numpy) whose LQ are smooth fields of ``lr_hw``
    drawn from ``rng``."""
    return pair_from_lq(smooth_lr(rng, n, *lr_hw, div), scale, amp, period)


def srflow_pair_t(generator, n, lr_hw, scale=4, amp=0.1, period=2, div=3):
    """``n`` SRFlow pairs as float32 tensors on ``generator``'s device, the
    coarse field drawn from ``generator``: in torch, the function
    ``pair_from_lq(smooth_from_coarse(coarse, *lr_hw), ...)`` computes."""
    coarse = torch.rand(coarse_shape(n, *lr_hw, div), generator=generator,
                        device=generator.device)
    h, w = lr_hw
    lq = 0.25 + 0.5 * resize_bilinear(coarse, (h, w))
    pat = torch.as_tensor(amp * checker(h * scale, w * scale, period),
                          device=coarse.device)
    gt = torch.clamp(resize_bilinear(lq, (h * scale, w * scale)) + pat, 0.0,
                     1.0)
    return {"GT": gt, "LQ": lq}


# ---------------------------------------------------------------------------
# the curves' loop and report
# ---------------------------------------------------------------------------

def card(device):
    """The card's name and power limit as ``nvidia-smi`` gives them, for
    a CUDA ``device``; else the device's name."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[device.index or 0]


def marks(steps, at, first, last):
    """The steps whose loss a curve prints: ``at`` below ``steps``, the
    first ``first``, the last ``last`` and the last step."""
    return sorted({m for m in at if m < steps} | set(range(min(first, steps)))
                  | set(range(max(0, steps - last), steps)))


def train(step, batch_of, steps):
    """Run ``step(batch_of(i))`` for i < ``steps`` (each step returns its
    metrics as floats, one host fetch), the kernel launch counters reset
    before each step and read after it.  Returns (every step's loss, ms a
    step after the first: the host clock over the rest, each of which ends
    on its loss's fetch, every step's launches {kernel: count})."""
    from bfsr_tpu_torch.ops import cuda

    losses, launches = [], []
    t1 = None
    for i in range(steps):
        batch = batch_of(i)
        cuda.reset_launch_counts()
        losses.append(step(batch)["loss"])
        launches.append({k: v for k, v in cuda.LAUNCHES.items() if v})
        if i == 0:
            t1 = time.perf_counter()
    ms = ((time.perf_counter() - t1) * 1e3 / (steps - 1)
          if steps > 1 else float("nan"))
    return losses, ms, launches


def summary(losses, first, last):
    """(mean of the first ``first`` losses, of the last ``last``)."""
    return float(np.mean(losses[:first])), float(np.mean(losses[-last:]))


def report(title, curve, at, first, last, where, log=print):
    """Print a curve (``run``'s dict): the loss at its marks, the first /
    last means, ms a step, a step's launches and the held-out metrics,
    each line with ``where`` (the card)."""
    losses = curve["losses"]
    log(f"{title}: {len(losses)} steps, {curve['ms']:.3f} ms/step after the "
        f"first; launches a step {curve['launches'][0]} [{where}]")
    for m in marks(len(losses), at, first, last):
        log(f"  step {m:>5}: {losses[m]!r}")
    f, l = summary(losses, first, last)
    log(f"  mean first {first}: {f!r}   mean last {last}: {l!r}   ratio "
        f"{l / f!r}   drop {f - l!r} [{where}]")
    for metric, values in curve["held_out"].items():
        for name, v in values.items():
            log(f"  held-out {metric} {name}: {v!r} [{where}]")
