"""K2's device times at the main paths' four shapes, to compare two trees.

Times ``affine_info`` (``csrc/linf_info.cu``) at C = 256 with two hidden
layers, as the LINF-LP flagship and its patch model run it: out_dim 60 on
the 512^2 grid of an LR 128^2 map and the 300x250 grid of LR 96x80, and
out_dim 540 (the d = 27 patch model) on the 172^2 centre grid of LR 128^2
and the 135x114 grid of LR 101x85.  The MLP's weights are random from
numpy seed 0 (uniform in +-1/sqrt(fan_in), biases 0.1 N(0, 1)), packed
with ``pack_mlp``; coef, freq and phase are N(0, 1) from numpy seed 1, on
grid-centre coordinates.  CUDA events around ``--iters`` back-to-back
launches after a warm-up, the device held while the host enqueues them
(as ``chip_smoke.py`` times).  Prints one JSON line: ms per launch, the
bound and its share (the least time for f32-grade work on the card:
the larger of 3 x flops over the 495 TFLOP/s TF32 rate, 3xTF32, and the
bytes over 3.35 TB/s), the SIMT f32 bound (flops over 67 TFLOP/s) and
its share, the max abs error against the plain twin, and the card's name
and power limit.

It uses only ``affine_info``, ``affine_info_plain`` and ``pack_mlp``,
which the port has had since K2 took wide outputs, so the same file times
an older checkout of the port:

    PYTHONPATH=<checkout> python bfsr_tpu_torch/profiling/k2_times.py
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bfsr_tpu_torch.ops.cuda import linf_info

C, N_HIDDEN = 256, 2
# (label, LR (h, w), query grid (H, W), out_dim)
SHAPES = [("512^2 out 60", (128, 128), (512, 512), 60),
          ("300x250 out 60", (96, 80), (300, 250), 60),
          ("patch 172^2 out 540", (128, 128), (172, 172), 540),
          ("patch 135x114 out 540", (101, 85), (135, 114), 540)]
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12


def random_mlp(out_dim, seed=0):
    """[(weight (out, in), bias)] of 4C -> C, (C -> C) x N_HIDDEN, C ->
    out_dim, on the CPU."""
    g = np.random.default_rng(seed)
    dims = [4 * C] + [C] * (N_HIDDEN + 1) + [out_dim]
    return [(torch.from_numpy(g.uniform(-1, 1, (o, i)) / np.sqrt(i)).float(),
             torch.from_numpy(0.1 * g.standard_normal(o)).float())
            for i, o in zip(dims[:-1], dims[1:])]


def grid_centres(n):
    return torch.from_numpy((np.arange(n) * 2 + 1) / n - 1).float()


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


def bounds(flops, n_bytes):
    """(bound ms, what bounds it, SIMT f32 bound ms)."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations (3xTF32)" if t_ops >= t_bytes else "bytes",
            1e3 * max(flops / PEAK_F32, t_bytes))


def run(iters=20):
    dev = torch.device("cuda")
    out = {}
    for label, (h, w), (H, W), out_dim in SHAPES:
        mlp = [(wl.to(dev), bl.to(dev)) for wl, bl in random_mlp(out_dim)]
        packed = linf_info.pack_mlp(mlp)
        g = np.random.default_rng(1)
        coef, freq = (torch.from_numpy(g.standard_normal((1, h, w, C)))
                      .float().to(dev) for _ in range(2))
        phase = torch.from_numpy(g.standard_normal(C // 2)).float().to(dev)
        cy, cx = grid_centres(H).to(dev), grid_centres(W).to(dev)
        args = (coef, freq, cy, cx, phase, mlp)
        n = H * W
        flops = 2 * n * sum(wl.numel() for wl, _ in mlp)
        n_bytes = 4 * (coef.numel() + freq.numel() + H + W + phase.numel()
                       + packed.numel() + out_dim * n)
        bound_ms, bound_by, simt_ms = bounds(flops, n_bytes)
        with torch.inference_mode():
            got = linf_info.affine_info(*args, packed)
            ref = linf_info.affine_info_plain(*args)
            err = float((got - ref).abs().max())
            ms = device_ms(lambda: linf_info.affine_info(*args, packed),
                           iters)
        out[label] = {"ms": ms, "gflop": flops / 1e9, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bound_share": bound_ms / ms,
                      "simt_bound_ms": simt_ms, "simt_share": simt_ms / ms,
                      "max_abs_err": err,
                      "max_abs_ref": float(ref.abs().max())}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "k2": run(args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
