"""Where a launch of K5 at the wide levels (C = 48 and 192) spends its
time, stage by stage, on the card.

Builds a copy of the kernel sources into ``bfsr_tpu_torch/_build/
k5_stages/`` with one kernel stamped: thread 0 of the launch's first
block (rank 0 of the first cluster) writes ``clock64()`` at each stage
boundary of its first tile.  ``--form f32`` stamps ``csrc/flow_step.cu``'s
``flow_step_wide_kernel``; ``--form xla`` or ``pallas`` the one-pass
wide kernel of that form in ``csrc/flow_step_bf16.cu``,
``flow_step_bf16_wide_kernel``.  The stamps are placed at the
kernel's own stage comments and statements, so an edit that moves one
fails here by name.  At ``k5_times.py --levels x8``'s shapes (the same
random step, state and record), it runs each direction a few times, then
once more and reads the stamps: the SM cycles of each stage and its share
of the tile.  A stage is the time from the stamp before it to its own, as
the stamping warp saw it (a stage the direction does not run is left
out); ``cb ...`` is a cluster barrier (its wait for the slowest CTA of
the cluster), ``... wait`` an mbarrier's (for the bytes the other CTAs
store into this one), ``... stores`` the issue of this CTA's.  At B 1 of
32^2 x 192 and 64^2 x 48 a cluster takes one tile, so the first tile is
the launch.

    PYTHONPATH=. python bfsr_tpu_torch/profiling/k5_stages.py \
        [--form f32|xla|pallas] [--reps 5]

prints one line per shape and direction and, last, one JSON line with
the cycles, the stamped launch's device time (beside ``k5_times.py``'s
of the kernel itself, the stamps' cost) and the card's name and power
limit.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import flow_step as k5
from bfsr_tpu_torch.profiling.k5_times import HID, device_ms, random_step

SHAPES = [("L4 32^2x192", 192, 32, 1), ("L3 64^2x48", 48, 64, 1),
          ("L4 B2 10^2x192", 192, 10, 2), ("L3 B2 20^2x48", 48, 20, 2)]
# (stage, anchor, whether the stamp goes after the anchor): each anchor is
# a line of the kernel that occurs once in it (END: the kernel's closing
# brace); the stamp k closes stage k
END = None
STAMPS = [
    ("entry", "  const int ks3 = warp / (G::NG3 * G::MG3);\n", True),
    ("window", "    __syncthreads();  // the window (and, the first tile, "
     "the kept weights)\n", True),
    ("fold", "      // every CTA runs and is done with the last tile's "
     "maps, and this\n", False),
    ("cb fold", "      // CTA's threads with the state window under s_z\n"
     "      cluster_sync();\n", True),
    ("z1 stores, cb z1", "      cluster_sync();  // z1 on the window in "
     "every CTA\n", True),
    ("conv1", "    copy_w3(0);  // W3's first taps", False),
    ("h1 epilogue, stores", "    cluster_sync();  // the map after conv1, "
     "whole in every CTA\n", False),
    ("cb h1", "    cluster_sync();  // the map after conv1, whole in every "
     "CTA\n", True),
    ("conv2", "    // the coupling reads the state and the records", False),
    ("h2 epilogue, stores", "    cluster_sync();  // the map after conv2 in "
     "every CTA\n", False),
    ("cb h2", "    cluster_sync();  // the map after conv2 in every CTA\n",
     True),
    ("conv3", "    if constexpr (REV) {\n      cluster_sync();  // every "
     "CTA is done with h2", False),
    ("sync after conv3", "    // (scale, shift) -> forward", False),
    ("coupling", "    // ---- D (reverse)", False),
    ("cb t", "      cluster_sync();  // t whole in every CTA\n", True),
    ("inverse fold, end", "    first = false;\n", False),
]
ENTRY = "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
STAMPS_BF16_WIDE = [
    ("entry", ENTRY, True),
    ("loads issued", "    cp_async_wait<REV && !LATE3 ? 1 : 0>();\n", False),
    ("window", "    __syncthreads();  // the window and the first group\n",
     True),
    ("z1 window wait", "    if constexpr (REV) mbar_wait(bar + 4, ph);  // "
     "the z1 window, whole\n", True),
    ("fold", "      // za = (fold + b_fold", False),
    ("fold epilogue", "      if constexpr (!G::ZX) {\n        // every CTA",
     False),
    ("cb fold", "        cluster_sync();\n      }\n", True),
    ("z1 local", "      __syncthreads();  // the CTA's z1 channels on the "
     "window\n", False),
    ("z1 stores", "      mbar_wait(bar, ph);  // z1 on the window, whole\n",
     False),
    ("z1 wait", "      mbar_wait(bar, ph);  // z1 on the window, whole\n",
     True),
    ("conv1", "    if constexpr (LATE3) cp_async_commit();  // W3 (and the "
     "fold rows)\n", False),
    ("h1 stores", "    mbar_wait(bar + 1, ph);  // the map after conv1, "
     "whole\n", False),
    ("h1 wait", "    mbar_wait(bar + 1, ph);  // the map after conv1, "
     "whole\n", True),
    ("conv2", "    cp_async_wait<0>();\n    __syncthreads();  // the CTA's "
     "h2 channels", False),
    ("h2 stores", "    mbar_wait(bar + 2, ph);  // the map after conv2, "
     "whole\n", False),
    ("h2 wait", "    mbar_wait(bar + 2, ph);  // the map after conv2, "
     "whole\n", True),
    ("conv3", "    __syncthreads();  // conv3's (scale, shift) (and the "
     "coupling's inputs)\n", False),
    ("coupling", "    // ---- D (reverse): t to every CTA", False),
    ("t stores", "      mbar_wait(bar + 3, ph);  // t, whole\n", False),
    ("t wait", "      mbar_wait(bar + 3, ph);  // t, whole\n", True),
    ("inverse fold, end", "  };\n  const int tile0 = blockIdx.x / NC;\n",
     False),
]
# --form -> (source, the kernel's name, its template line, the stamps)
KERNELS = {
    "f32": ("flow_step.cu", "flow_step_wide_kernel(",
            "template <int C, bool REV>", STAMPS),
    "bf16": ("flow_step_bf16.cu", "flow_step_bf16_wide_kernel(",
             "template <int C, bool REV, bool PALLAS>", STAMPS_BF16_WIDE),
}
READER = """
extern "C" int k5_stage_clocks(long long* h) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(h, k5_stage_clock, sizeof(k5_stage_clock)));
}
extern "C" int k5_stage_clocks_clear() {
  return static_cast<int>(
      cudaMemset(k5_stage_clock_ptr(), 0, sizeof(k5_stage_clock)));
}
"""


def stamped(src, kernel, template, stamps):
    """A kernel source with the stage stamps of ``kernel`` (its name and
    ``(``), ``template`` the line that opens its definition."""
    k = src.index(kernel)
    head, body = src[:k], src[k:]
    body = body[:body.index("\n}\n") + 3]
    tail = src[k + len(body):]
    for i, (stage, anchor, after) in enumerate(stamps):
        stamp = f"    K5_STAMP({i});\n"
        if anchor is END:
            body = body[:-2] + stamp + "}\n"
            continue
        if body.count(anchor) != 1:
            raise RuntimeError(f"k5_stages: the anchor of stage {stage!r} "
                               f"occurs {body.count(anchor)} times in "
                               f"{kernel[:-1]}")
        body = body.replace(anchor, anchor + stamp if after else
                            stamp + anchor)
    body = body.replace(
        "    K5_STAMP(0);\n",
        "    bool k5_stamp = blockIdx.x == 0 && blockIdx.y == 0 &&\n"
        "                    blockIdx.z == 0 && threadIdx.x == 0;\n"
        "    K5_STAMP(0);\n", 1)
    body = body.replace(f"    K5_STAMP({len(stamps) - 1});\n",
                        f"    K5_STAMP({len(stamps) - 1});\n"
                        "    k5_stamp = false;\n", 1)
    defs = (f"__device__ long long k5_stage_clock[{len(stamps)}];\n"
            "void* k5_stage_clock_ptr() {\n  void* p = nullptr;\n"
            "  cudaGetSymbolAddress(&p, k5_stage_clock);\n  return p;\n}\n"
            "#define K5_STAMP(k) \\\n  do { if (k5_stamp) "
            "k5_stage_clock[k] = clock64(); } while (0)\n")
    kt = head.rindex(template)
    return head[:kt] + defs + head[kt:] + body + tail + READER


def build_stamped(key):
    """Point the kernel library at a copy of csrc/ with the kernel of
    ``key`` (``KERNELS``) stamped, and build it."""
    source, kernel, template, stamps = KERNELS[key]
    dst = cuda.BUILD_DIR / "k5_stages"
    shutil.rmtree(dst, ignore_errors=True)
    (dst / "csrc").mkdir(parents=True)
    for src in cuda._sources():
        text = src.read_text()
        if src.name == source:
            text = stamped(text, kernel, template, stamps)
        (dst / "csrc" / src.name).write_text(text)
    cuda.CSRC, cuda.BUILD_DIR = dst / "csrc", dst / "build"
    lib = cuda.library()
    lib.k5_stage_clocks.argtypes = [ctypes.c_void_p]
    lib.k5_stage_clocks.restype = ctypes.c_int
    lib.k5_stage_clocks_clear.restype = ctypes.c_int
    return lib


def stages(lib, fn, stamps, reps):
    """{stage: cycles} of fn()'s last launch (a stage the direction does
    not run is left out)."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    if lib.k5_stage_clocks_clear() != 0:
        raise RuntimeError("k5_stages: clearing the stamps failed")
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * len(stamps))()
    if lib.k5_stage_clocks(buf) != 0:
        raise RuntimeError("k5_stages: reading the stamps failed")
    t = list(buf)
    if not (t[0] and t[-1]):
        raise RuntimeError("k5_stages: the launch wrote no stamps at its "
                           "entry and end: the stamped kernel did not run")
    out, prev = {}, t[0]
    for i, (stage, _, _) in enumerate(stamps[1:], 1):
        if t[i] > prev:
            out[stage] = t[i] - prev
            prev = t[i]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--form", choices=("f32", "xla", "pallas"),
                    default="f32")
    args = ap.parse_args(argv)
    key = "f32" if args.form == "f32" else "bf16"
    if not torch.cuda.is_available():
        print("k5_stages: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    lib = build_stamped(key)
    stamps = KERNELS[key][3]
    saved = fnn.precision_mode()
    fnn.set_default_precision("high" if args.form == "f32" else "default")
    try:
        rows = run(lib, stamps, args)
    finally:
        fnn.set_default_precision(saved)
    print(json.dumps({"card": smi, "form": args.form, "k5_stages": rows}))
    return 0


def run(lib, stamps, args):
    rows = {}
    for label, c, hw, batch in SHAPES:
        step = random_step(c)
        if args.form == "f32":
            packed = k5.pack_step(step.actnorm, step.invconv,
                                  step.affine).cuda()
            call = {"fwd": lambda x, r: k5.flow_step_forward(
                        x, r, packed, HID),
                    "rev": lambda x, r: k5.flow_step_reverse(
                        x, r, packed, HID)}
        else:
            packed = k5.pack_step_bf16(step.actnorm, step.invconv,
                                       step.affine, args.form).cuda()
            call = {"fwd": lambda x, r: k5.flow_step_forward(
                        x, r, None, HID, packed, args.form),
                    "rev": lambda x, r: k5.flow_step_reverse(
                        x, r, None, HID, packed, args.form)}
        g = np.random.default_rng(1)
        shape = (batch, hw, hw)
        x = torch.from_numpy(g.standard_normal((*shape, c))).float().cuda()
        rec = torch.from_numpy(np.concatenate(
            [g.uniform(0.6, 1.0, (*shape, c)),
             0.5 * g.standard_normal((*shape, c)),
             g.standard_normal((*shape, HID))], -1)).float().cuda()
        with torch.inference_mode():
            inputs = {"fwd": x, "rev": call["fwd"](x, rec)}
            for name, fn in call.items():
                inp = inputs[name]
                cyc = stages(lib, lambda: fn(inp, rec), stamps, args.reps)
                total = sum(cyc.values())
                ms = device_ms(lambda: fn(inp, rec), args.iters)
                rows[f"{label} {name}"] = {"cycles": cyc, "tile": total,
                                           "stamped_ms": ms}
                print(f"{label} {name}: tile {total} cycles, launch "
                      f"{ms:.4f} ms stamped: " + ", ".join(
                          f"{s} {v} ({v / total:.0%})"
                          for s, v in cyc.items()), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
