"""Fast sanity check of the port: the counterpart of ``selfcheck.py``.

    python -m bfsr_tpu_torch.cli.selfcheck [--device cuda|cpu]

Prints the torch and CUDA versions and the state of the kernel library
(``ops.cuda.library()``: built from ``bfsr_tpu_torch/csrc`` at first use,
and its build seconds), then runs a small LINF-LP learned-prior predict
(LR 8^2 -> HR 32^2) and a small SRFlow encode / decode roundtrip (GT 16^2
over LQ 4^2, max abs error under 1e-2, as the JAX selfcheck holds it).
The models are the smallest the kernels take (K2's hidden 128, K3's Cout
16 and 8, K5's hidden 64), random from seed 0.  ``--device cuda`` (the
default) runs the kernels and prints each one's launches; with no card it
raises.  ``--device cpu`` runs their plain twins.
"""

import argparse
import sys
import time

import numpy as np
import torch

LINF_SPEC = {"name": "linf", "args": {
    "encoder_spec": {"name": "edsr-baseline",
                     "args": {"n_resblocks": 2, "n_feats": 16,
                              "no_upsampling": True}},
    "imnet_spec": {"name": "flow", "args": {"name": "flow"}},
    "flow_layers": 3, "num_layer": 2, "hidden_dim": 128}}
UNET_SPEC = {"name": "unet", "args": {"in_chans": 3, "depth": 2, "dim": 16}}
SRFLOW_SPEC = {"name": "srflow", "args": {
    "nf": 8, "nb": 2, "gc": 8, "K": 2, "L": 3, "hidden_channels": 64,
    "stack_blocks": (0, 1)}}
ROUNDTRIP_TOL = 1e-2


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    t0 = time.time()
    device = torch.device(args.device)
    print(f"torch {torch.__version__} | CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]} | device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("selfcheck --device cuda: no CUDA device "
                           "(torch.cuda.is_available() is false); pass "
                           "--device cpu to check the plain twins")

    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import build_linf
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.ops import cuda
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
    from bfsr_tpu_torch.utils.coords import make_cell, make_coord

    if device.type == "cuda":
        cuda.library()
        print(f"kernels: built and loaded in {cuda.build_seconds:.2f} s "
              f"({torch.cuda.get_device_name(device)})")
    else:
        print("kernels: not built (--device cpu runs their plain twins)")
    cuda.reset_launch_counts()

    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    # LINF-LP learned-prior predict
    model, prior = build_linf(LINF_SPEC, UNET_SPEC, device, seed=0)
    H = W = 32
    inp = tensor(rng.random((1, 8, 8, 3)))
    coord = tensor(np.asarray(make_coord((H, W), flatten=False))[None])
    cell = tensor(make_cell((H, W))[None])
    gt_lr_up = tensor(rng.random((1, H, W, 3)) - 0.5)
    pred = LINFPredictor(model, prior).predict(inp, coord, cell, gt_lr_up)
    if not torch.isfinite(pred).all():
        raise RuntimeError("LINF-LP predict: non-finite output")
    print(f"LINF-LP learned-prior predict: OK {tuple(pred.shape)}")

    # SRFlow encode / decode roundtrip
    s = registry.make(SRFLOW_SPEC)
    s.reset_parameters(seeded(0))
    s = s.to(device).eval().freeze()
    lr = tensor(rng.random((1, 4, 4, 3)))
    gt = tensor(rng.random((1, 16, 16, 3)))
    with torch.no_grad():
        cache = s.precompute_ft(s.rrdb_preprocess(lr))
        sr = s.reverse_flow(s.normal_flow(gt, cache), cache)
        _, nll, _ = s.normal_flow_nll(gt, cache, noise=torch.zeros_like(gt))
    err = float((sr - gt).abs().max())
    if not err < ROUNDTRIP_TOL:
        raise RuntimeError(f"SRFlow roundtrip: max err {err:.3e} >= "
                           f"{ROUNDTRIP_TOL:g}")
    print(f"SRFlow encode/decode roundtrip: OK (max err {err:.1e}, nll "
          f"{float(nll.mean()):.3f})")
    if device.type == "cuda":
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda.LAUNCHES.items() if v}
        want = ("conv3x3_cat", "linf_info", "linf_flow_forward",
                "linf_flow_inverse", "flow_step_forward", "flow_step_reverse")
        missing = [k for k in want if not launched.get(k)]
        if missing:
            raise RuntimeError(f"kernels that did not launch: {missing}")
        print(f"launches: {launched}")
    print(f"selfcheck passed in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
