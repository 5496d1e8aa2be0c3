"""Where the spatial SRFlow-LP predict's strips leave the single predict:
each stage of each rank's strip (the RRDB's conditioning maps, the
epses, the learned epses, the SR image) against the same columns of
``SRFlowLPPredictor.run`` on the same padded LR
(``parallel.sharded.stage_errors``).

    python -m bfsr_tpu_torch.profiling.spatial_stages [--lr 101 85]
        [--mode high|default] [--twins] [--cpu]

The flagship SRFlow-LP (``entry.build_srflow_lp``, random weights from
seed 0) on the card, or with ``--cpu`` the CPU test size on the CPU, on
one LR image from ``np.random.default_rng(174)``; ``--twins`` runs the
twin path (``kernels=False``: every conv on the library) in place of the
kernels.  The ranks are two gloo processes (``parallel.mesh.spawn``)
sharing the one device, as in ``chip_smoke.py``.  Prints one line per
rank: {stage: max abs err}.  ``chip_smoke.py`` holds the strips
themselves; this finds the stage where one leaves the whole.
"""

import argparse

import numpy as np

from bfsr_tpu_torch.parallel.mesh import spawn
from bfsr_tpu_torch.parallel.sharded import run_cases, stage_errors
from bfsr_tpu_torch.pipelines.srflow_eval import STAGES


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lr", type=int, nargs=2, default=(101, 85))
    parser.add_argument("--mode", default="high")
    parser.add_argument("--twins", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    lr = np.random.default_rng(174).random((*args.lr, 3)).astype(
        np.float32)
    keep = tuple(s for s in STAGES if s != "precompute_ft")
    n = 2
    case = {"predict": "srflow_sp",
            "recipe": {"seed": 0, "tiny": args.cpu}, "inputs": {"lr": lr},
            "mesh": {"sp": n},
            "opts": {"kernels": not args.twins, "mode": args.mode,
                     "stages": keep}}
    device = "cpu" if args.cpu else "cuda"
    ranks = spawn(run_cases, n, "gloo", args=([case], device),
                  init_timeout=120.0, join_timeout=400.0,
                  device=f"{device}:0" if device == "cuda" else None)
    single = run_cases([dict(case, mesh=None, opts=dict(case["opts"], sp=n))],
                       device)[0]
    path = "twin" if args.twins else "kernel"
    for r, got in enumerate(ranks):
        errs = stage_errors(got[0]["stages"], single["stages"], r, n)
        print(f"spatial stages LR {args.lr[0]}x{args.lr[1]} {args.mode} "
              f"{path} path, rank {r} of {n}: max abs err by stage {errs}",
              flush=True)


if __name__ == "__main__":
    main()
