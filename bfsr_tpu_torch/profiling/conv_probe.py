"""P1-P3: the bf16 design probe of K3's one-pass form.

The counterpart of ``profiling/mosaic_probe.py`` (``kern_a`` :36,
``kern_b`` :85, ``kern_c`` :145): one 3x3 SAME conv, Cin 64 -> Cout 192,
over a 128x128 image, with bf16 operands and f32 accumulation.  The JAX
probe computes it three ways, each a layout of the space-to-depth domain
chosen for the TPU's 128 lanes (the dense 2x2 s2d, an exact per-phase
im2col, a y-only split).  Those are lane choices with no counterpart on
Hopper: the port computes their one function once, on the bf16 K3
(``csrc/conv3x3_bf16.cu``), and times it beside one cuDNN bf16 conv.

On the card (from the repository root):

    python -m bfsr_tpu_torch.profiling.conv_probe
"""

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from bfsr_tpu_torch.ops.cuda.conv3x3 import (conv3x3_cat_bf16,
                                             conv3x3_cat_bf16_plain,
                                             conv3x3_cat_plain,
                                             kernel_weight_bf16)

SIZE, CIN, COUT = 128, 64, 192
# the bf16 kernel against its twin: both multiply the same bf16 values
# exactly and differ only in the order of the f32 sums
TOL = (1e-4, 1e-4)


def probe_inputs(size=SIZE, cin=CIN, cout=COUT, seed=0):
    """(x (1, size, size, cin), w (3, 3, cin, cout) HWIO) as
    ``mosaic_probe.py:27-29`` makes them."""
    rng = np.random.default_rng(seed)
    x = rng.random((1, size, size, cin)).astype(np.float32)
    w = (rng.random((3, 3, cin, cout)) - 0.5).astype(np.float32) * 0.1
    return x, w


def _gpu_ms(fn, iters):
    """Mean device time of fn() over ``iters`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def run(device="cuda", size=SIZE, cin=CIN, cout=COUT, iters=20):
    """Run the probe once on ``device``.  Returns a dict: ``flops`` (the
    useful 2 size^2 9 cin cout), ``max_abs_err`` against the f32 conv,
    ``twin_max_abs_err`` against the bf16 twin (raises past ``TOL``),
    and on a CUDA device ``ms``, ``tflops``, ``plain_ms`` (the twin) and
    ``library_ms`` (cuDNN bf16 ``F.conv2d``, bf16 out), each a CUDA-event
    mean over ``iters`` launches.  On the CPU the twin computes and every
    time is None: not measured."""
    device = torch.device(device)
    x_np, w_np = probe_inputs(size, cin, cout)
    x = torch.as_tensor(x_np, device=device)
    w = torch.as_tensor(np.ascontiguousarray(w_np.transpose(3, 2, 0, 1)),
                        device=device)
    kw = kernel_weight_bf16(w)

    def kernel():
        return conv3x3_cat_bf16([x], w, kweight_bf16=kw)

    def twin():
        return conv3x3_cat_bf16_plain([x], w)

    y, y_twin, y32 = kernel(), twin(), conv3x3_cat_plain([x], w)
    err = (y - y_twin).abs()
    if not bool((err <= TOL[0] + TOL[1] * y_twin.abs()).all()):
        raise RuntimeError(f"conv_probe: the bf16 kernel disagrees with its "
                           f"twin: max abs err {float(err.max()):.3e}")
    flops = 2 * size * size * 9 * cin * cout
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "shape": [1, size, size, cin, cout], "flops": flops,
           "max_abs_err": float((y - y32).abs().max()),
           "max_abs_ref": float(y32.abs().max()),
           "twin_max_abs_err": float(err.max()),
           "ms": None, "tflops": None, "plain_ms": None, "library_ms": None}
    if device.type == "cuda":
        xb = x.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ms = _gpu_ms(kernel, iters)
        out.update(ms=ms, tflops=flops / ms / 1e9,
                   plain_ms=_gpu_ms(twin, iters),
                   library_ms=_gpu_ms(lambda: F.conv2d(xb, wb, padding=1),
                                      iters))
    return out


def main():
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
