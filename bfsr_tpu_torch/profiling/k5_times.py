"""K5's device times at the three flow levels' shapes, to compare two trees.

Times ``flow_step_forward`` and ``flow_step_reverse`` in one form
(``--form``): ``f32`` (the default; ``csrc/flow_step.cu``), or one of the
one-pass forms under ``BFSR_PRECISION=default``, ``xla`` (served) or
``pallas`` (``csrc/flow_step_bf16.cu``), at SRFlow-LP's level shapes of a
512^2 image:
256^2 x 12, 128^2 x 24 and 64^2 x 96, each with a conditioning record of
2C + 64 channels; ``--levels x8``: the 8x model's levels 3 and 4 at
512^2 (64^2 x 48, 32^2 x 192; its levels 1 and 2 are the 4x model's),
the same two at a ``validate`` batch of 2 160^2 crops (B 2 of 20^2 x 48
and of 10^2 x 192), at the 8x trainer's batch of 12 (B 12 of the same;
no path launches K5 there, the base trainer runs its flow unfused) and
at a 2048^2 sample (256^2 x 48, 128^2 x 192: more tiles than the card
holds clusters), each image with its own state and record.
The step is a ``FlowStep`` with live random weights from seed 0, built
as ``tests/test_torch_cuda.py:random_flow_step`` builds it, and packed
with ``pack_step`` (f32) or ``pack_step_bf16`` in the form; the state and
record come from numpy seed 1.  CUDA events around ``--iters``
back-to-back launches after a warm-up, the device held while the host
enqueues them (as ``chip_smoke.py`` times).  Prints one JSON line: ms
per launch, the share of the bound (``ops/cuda/flow_step.py:k5_cost``:
the larger of the step's products, each over the peak of what runs it,
and its bytes over 3.35 TB/s), the max abs error against the plain twin,
and the card's name and power limit.  At C = 48 and 192, whose kernels
run their f32-grade products on the tensor cores, the share with those
products at the f32 SIMT rate (the instructions of the narrow widths'
kernels) is beside it (f32 and ``xla``).

It times any checkout of the port that has ``k5_cost``; an older one
runs its own copy of this file (the same timing, shapes and seeds):

    PYTHONPATH=<checkout> python bfsr_tpu_torch/profiling/k5_times.py \
        --form xla
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bfsr_tpu_torch.models.srflow.flow_upsampler import FlowStep
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import flow_step as k5

HID = 64
# (label, C, extent, batch): the first conditional step of each level at
# 512^2 (x8: and of a validate batch, B 2, and the 8x trainer's B 12 of
# 160^2, and at 2048^2)
LEVELS = {"x4": [("L1 256^2x12", 12, 256, 1), ("L2 128^2x24", 24, 128, 1),
                 ("L3 64^2x96", 96, 64, 1)],
          "x8": [("L3 64^2x48", 48, 64, 1), ("L4 32^2x192", 192, 32, 1),
                 ("L3 B2 20^2x48", 48, 20, 2),
                 ("L4 B2 10^2x192", 192, 10, 2),
                 ("L3 B12 20^2x48", 48, 20, 12),
                 ("L4 B12 10^2x192", 192, 10, 12),
                 ("L3 256^2x48", 48, 256, 1),
                 ("L4 128^2x192", 192, 128, 1)]}
FORMS = ("f32", "xla", "pallas")


def random_step(c, seed=0):
    """A conditional FlowStep with live random weights (nonzero actnorms
    and Conv2dZeros tails)."""
    g = np.random.default_rng(seed)
    step = FlowStep(c, 320, HID)
    with torch.no_grad():
        for name, t in step.named_parameters():
            if name == "invconv.weight":
                q, _ = np.linalg.qr(g.standard_normal((c, c)))
                t.copy_(torch.from_numpy(q))
            elif name.endswith("weight"):
                t.copy_(torch.from_numpy(
                    g.standard_normal(t.shape) / np.sqrt(t[0].numel())))
            else:
                t.copy_(torch.from_numpy(0.1 * g.standard_normal(t.shape)))
    return step


def device_ms(fn, iters):
    """Mean device time of fn() over ``iters`` launches (CUDA events).  A
    sleep on the stream first holds the device while the host enqueues the
    timed calls (1.5x the host time they took, at 2 GHz or longer)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * (1.5 * host_ms + 1.0)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _entries(form, packed):
    """[(label, kernel fn, plain fn)] of both directions in ``form``, each
    called as fn(x, rec)."""
    if form == "f32":
        return [(d, lambda x, r, f=f: f(x, r, packed, HID),
                 lambda x, r, p=p: p(x, r, packed, HID))
                for d, f, p in (("fwd", k5.flow_step_forward,
                                 k5.flow_step_forward_plain),
                                ("rev", k5.flow_step_reverse,
                                 k5.flow_step_reverse_plain))]
    return [(d, lambda x, r, f=f: f(x, r, None, HID, packed, form),
             lambda x, r, rev=rev: k5.BF16_FORMS[form, rev][1](x, r, packed,
                                                               HID))
            for d, f, rev in (("fwd", k5.flow_step_forward, False),
                              ("rev", k5.flow_step_reverse, True))]


def run(iters=50, form="f32", levels="x4"):
    out = {}
    for label, c, hw, batch in LEVELS[levels]:
        step = random_step(c)
        packed = (k5.pack_step(step.actnorm, step.invconv, step.affine)
                  if form == "f32" else
                  k5.pack_step_bf16(step.actnorm, step.invconv, step.affine,
                                    form)).cuda()
        g = np.random.default_rng(1)
        shape = (batch, hw, hw)
        x = torch.from_numpy(g.standard_normal((*shape, c))).float().cuda()
        rec = torch.from_numpy(np.concatenate(
            [g.uniform(0.6, 1.0, (*shape, c)),
             0.5 * g.standard_normal((*shape, c)),
             g.standard_normal((*shape, HID))], -1)).float().cuda()
        bound_ms = k5.k5_cost(c, HID, (batch * hw, hw), packed,
                              form)["bound_ms"]
        simt_ms = (k5.k5_cost(c, HID, (batch * hw, hw), packed, form,
                              simt=True)["bound_ms"]
                   if c in k5.WIDE_CHANNELS and form != "pallas" else None)
        entries = _entries(form, packed)
        with torch.inference_mode():
            inputs = {"fwd": x, "rev": entries[0][2](x, rec)}
            row = {"bound_ms": bound_ms}
            if simt_ms is not None:
                row["simt_bound_ms"] = simt_ms
            for name, fn, plain in entries:
                inp = inputs[name]
                err = (fn(inp, rec) - plain(inp, rec)).abs()
                ms = device_ms(lambda: fn(inp, rec), iters)
                row[name] = {"ms": ms, "bound_share": bound_ms / ms,
                             "max_abs_err": float(err.max()),
                             "mean_abs_err": float(err.mean())}
                if simt_ms is not None:
                    row[name]["simt_share"] = simt_ms / ms
        out[label] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--form", choices=FORMS, default="f32",
                    help="f32: the f32 kernel; xla / pallas: that one-pass "
                    "form under BFSR_PRECISION=default")
    ap.add_argument("--levels", choices=sorted(LEVELS), default="x4",
                    help="x4: the 4x flow's three levels; x8: the 8x "
                    "flow's levels 3 and 4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    saved = fnn.precision_mode()
    fnn.set_default_precision("high" if args.form == "f32" else "default")
    try:
        times = run(args.iters, args.form, args.levels)
    finally:
        fnn.set_default_precision(saved)
    print(json.dumps({"label": args.label, "card": smi,
                      f"k5_{args.form}": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
