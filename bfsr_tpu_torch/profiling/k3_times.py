"""K3's device times at the main paths' conv shapes, to compare two trees.

Times the f32 K3 (``conv3x3_cat``) and the bf16 K3 (``conv3x3_cat_bf16``)
beside cuDNN (f32 with TF32 off; bf16) at the LINF-LP encoder conv (64 ->
64 @128^2), ``dense5c`` conv5 (131 -> 32 @512^2), the last ``up`` conv1
(128 -> 64 @512^2) and the SRFlow-LP RRDB's conv4 (160 -> 32 @128^2) and
conv5 (192 -> 64 @128^2): random weights and inputs from seed 0, CUDA
events around ``--iters`` back-to-back launches after a warm-up, the
device held while the host enqueues them (as ``chip_smoke.py`` times).
Prints one JSON line of mean ms per launch and the card's name and power
limit.

It uses only entry points the port has had since its bf16 K3 came in, so
the same file times an older checkout of the port:

    PYTHONPATH=<checkout> python bfsr_tpu_torch/profiling/k3_times.py
"""

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from bfsr_tpu_torch.ops.cuda import conv3x3

# (label, input channels, Cout, extent)
SHAPES = [("encoder 64->64 @128^2", [64], 64, 128),
          ("dense5c 131->32 @512^2", [3, 32, 32, 32, 32], 32, 512),
          ("up 128->64 @512^2", [64, 64], 64, 512),
          ("RRDB conv4 160->32 @128^2", [64, 32, 32, 32], 32, 128),
          ("RRDB conv5 192->64 @128^2", [64, 32, 32, 32, 32], 64, 128)]


def device_ms(fn, iters):
    """Mean device time of fn() over ``iters`` launches (CUDA events).  A
    sleep on the stream first holds the device while the host enqueues the
    timed calls (1.5x the host time they took, at 2 GHz or longer), so a
    launch shorter than its host work is still timed on the device."""
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


def run(iters=20):
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, cins, cout, hw in SHAPES:
        xs = [torch.randn((1, hw, hw, c), generator=gen, device="cuda")
              for c in cins]
        w = torch.randn((cout, sum(cins), 3, 3), generator=gen,
                        device="cuda") / (3 * sum(cins) ** 0.5)
        b = torch.randn((cout,), generator=gen, device="cuda")
        kw, kwb = conv3x3.kernel_weight(w), conv3x3.kernel_weight_bf16(w)
        xcat = torch.cat(xs, -1).permute(0, 3, 1, 2).contiguous()
        xb, wb, bb = xcat.bfloat16(), w.bfloat16(), b.bfloat16()
        with torch.inference_mode():
            out[label] = {
                "f32": device_ms(lambda: conv3x3.conv3x3_cat(
                    xs, w, None, b, "lrelu", kweight=kw), iters),
                "cudnn_f32": device_ms(
                    lambda: F.conv2d(xcat, w, b, padding=1), iters),
                "bf16": device_ms(lambda: conv3x3.conv3x3_cat_bf16(
                    xs, w, None, b, "lrelu", kweight_bf16=kwb), iters),
                "cudnn_bf16": device_ms(
                    lambda: F.conv2d(xb, wb, bb, padding=1), iters)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi,
                      "ms": run(args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
