"""The three learning-curve scripts (``bfsr_tpu_torch/profiling/
train_curve.py``, ``srflow_train_curve.py``, ``prior_train_curve.py``)
end to end on the CPU at the tiny sizes (``run(tiny=True)``): two steps
each at the curves' batch shapes, every loss finite, no kernel launched (on CPU
tensors every wrapper runs its twin), the held-out metrics each curve
reports, and the report's lines with the device beside the numbers.  On
the card they run at full size in ``chip_smoke.py``'s phase 19."""

import math

import pytest

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from bfsr_tpu_torch.profiling import (prior_train_curve, srflow_train_curve,
                                      train_curve)

HELD_OUT = {train_curve: {"psnr": {"no prior", "init", "trained"}},
            srflow_train_curve: {"psnr": {"init", "trained"},
                                 "nll": {"init", "trained"}},
            prior_train_curve: {"psnr": {"no prior", "init", "trained"}}}


@pytest.mark.parametrize("curve", list(HELD_OUT),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_curve_runs_tiny_on_the_cpu(curve):
    lines = []
    out = curve.run(steps=2, device="cpu", tiny=True, log=lines.append)
    assert len(out["losses"]) == 2
    assert all(math.isfinite(v) for v in out["losses"])
    assert out["launches"] == [{}, {}]
    assert math.isfinite(out["ms"]) and out["ms"] > 0
    assert {k: set(v) for k, v in out["held_out"].items()} == HELD_OUT[curve]
    assert all(math.isfinite(v) for vs in out["held_out"].values()
               for v in vs.values())
    assert lines[0].endswith("[cpu]")
    assert sum("held-out" in line for line in lines) == sum(
        len(v) for v in HELD_OUT[curve].values())


def test_linf_curve_seed_draws_the_weights_alone():
    """``train_curve.run(seed=...)`` draws other weights and leaves the
    task as it is: the losses and the init prior's PSNR move, the no-prior
    PSNR (the LR-up residual's latent inverted as it is: the bilinear
    baseline of the same held-out images) does not."""
    runs = [train_curve.run(steps=2, device="cpu", tiny=True, seed=s,
                            log=lambda line: None) for s in (0, 1)]
    a, b = (r["held_out"]["psnr"] for r in runs)
    assert runs[0]["losses"][0] != runs[1]["losses"][0]
    assert a["init"] != b["init"]
    assert a["no prior"] == pytest.approx(b["no prior"], abs=1e-3)
