"""K4's device times, forward and inverse, at four shapes, to compare two
trees.

Times ``flow_forward`` and ``flow_inverse`` (``csrc/linf_flow_nd.cuh``) at
L = 10 coupling layers: d = 27 (the patch model) on the 172^2 centre grid
of LR 128^2 (N = 29,584) and the 135x114 grid of LR 101x85 (N = 15,390,
whose info rows are not 16-B aligned), and d = 12 and d = 48 at N =
29,584.  Inputs are random from numpy seed 0: W near the identity (0.05 U(-1,
1) / sqrt(8) + I, as ``tests/test_torch_cuda.py`` draws it) with its
float64 inverse cast to f32, b 0.1 N(0, 1), x N(0, 1), info 0.5 N(0, 1)
channel-major (2dL, N).  CUDA events around ``--iters`` back-to-back
launches after a warm-up, the device held while the host enqueues them
(as ``chip_smoke.py`` times).  Prints one JSON line: ms per launch, the
byte bound (w, b, x and info read once, the output written once, over
3.35 TB/s; K4's flops are under a third of that time at the 67 TFLOP/s
SIMT f32 peak) and its share, the max abs error against the plain twin,
and the card's name and power limit.

It uses only ``flow_forward``, ``flow_inverse`` and their ``_plain``
twins, which the port has had since K4 was ported, so the same file
times an older checkout of the port:

    PYTHONPATH=<checkout> python bfsr_tpu_torch/profiling/k4_times.py
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bfsr_tpu_torch.ops.cuda import linf_flow

N_LAYERS = 10
# (label, d, N)
SHAPES = [("d27 172^2", 27, 172 * 172), ("d27 135x114", 27, 135 * 114),
          ("d12 172^2", 12, 172 * 172), ("d48 172^2", 48, 172 * 172)]
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def random_flow(d, n, seed=0):
    """(w, b, x, info, w_inv) as float32 CPU tensors."""
    g = np.random.default_rng(seed)
    w = (0.05 * g.uniform(-1, 1, (N_LAYERS + 1, d, d)) / np.sqrt(8)
         + np.eye(d))
    b = 0.1 * g.standard_normal((N_LAYERS + 1, d))
    x = g.standard_normal((n, d))
    info = 0.5 * g.standard_normal((2 * d * N_LAYERS, n))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (w, b, x, info, np.linalg.inv(w)))


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


def run(iters=50, dims=None):
    dev = torch.device("cuda")
    out = {}
    for label, d, n in SHAPES:
        if dims and d not in dims:
            continue
        w, b, x, info, w_inv = (t.to(dev) for t in random_flow(d, n))
        flops = n * ((N_LAYERS + 1) * (2 * d * d + d) + 7 * d * N_LAYERS)
        n_bytes = 4 * (w.numel() + b.numel() + 2 * x.numel() + info.numel())
        bound_ms = 1e3 * max(n_bytes / PEAK_BYTES, flops / PEAK_F32)
        with torch.inference_mode():
            z = linf_flow.flow_forward(w, b, x, info)
            xr = linf_flow.flow_inverse(w_inv, b, z, info)
            err_f = (z - linf_flow.flow_forward_plain(w, b, x, info)).abs()
            err_i = (xr - linf_flow.flow_inverse_plain(w_inv, b, z, info)
                     ).abs()
            ms_f = device_ms(lambda: linf_flow.flow_forward(w, b, x, info),
                             iters)
            ms_i = device_ms(
                lambda: linf_flow.flow_inverse(w_inv, b, z, info), iters)
        out[label] = {
            "d": d, "n": n, "n_layers": N_LAYERS,
            "fwd_ms": ms_f, "inv_ms": ms_i, "bound_ms": bound_ms,
            "bound_by": ("bytes" if n_bytes / PEAK_BYTES >= flops / PEAK_F32
                         else "operations"),
            "fwd_share": bound_ms / ms_f, "inv_share": bound_ms / ms_i,
            "fwd_max_abs_err": float(err_f.max()),
            "inv_max_abs_err": float(err_i.max()),
            "mbytes": n_bytes / 1e6, "gflop": flops / 1e9}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--d", type=int, action="append",
                    help="time only this d (repeatable; default all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi,
                      "k4": run(args.iters, args.d)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
