"""``chip_smoke.py``'s SRFlow-LP prior-trainer checks on the CPU, shown to
reject what they must: the one-pass ``FlowStepReverse`` gradient's limit
(``TOL['flow_step_bf16_reverse_grad']``) refuses the old rounding cast,
which also rounded the gradient; and the step's nudge-spread check
(``hold_step`` on the twin path's spread under LQ x (1 +- 1e-7)) refuses
a zero gradient and a wrong one."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from bfsr_tpu_torch.entry import (build_srflow_prior_trainer,
                                  example_srflow_train_batch)
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.ops.cuda import flow_step as k5

from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_srflow_train_parts import _grad, random_step, records


@pytest.mark.parametrize("c", [12, 24, 96])
def test_the_reverse_gradient_limit_rejects_a_rounding_cast(restore_modes, c):
    """FlowStepReverse's one-pass gradient is held to the twin's by
    ``within(..., TOL['flow_step_bf16_reverse_grad'])``, as on the card;
    the twin with a plain rounding under autograd (the old cast) reads
    ~6-11x the mean limit and is refused."""
    step = random_step(c, seed=c)
    g = np.random.default_rng(c + 1)
    x = torch.tensor(g.standard_normal((2, 9, 7, c)), dtype=torch.float32)
    up = torch.tensor(g.standard_normal((2, 9, 7, c)), dtype=torch.float32)
    rec = records(2, (9, 7), c)
    tnn.set_default_precision("default")
    pb, tol = step.kpacked_bf16, cs.TOL["flow_step_bf16_reverse_grad"]
    twin = _grad(lambda t: k5.flow_step_reverse_twin(
        t, rec, step.kpacked, 64, pb, step.step_form), x, up)
    served = _grad(lambda t: k5.flow_step_reverse_diff(
        t, rec, step.kpacked, 64, pb, step.step_form), x, up)
    old = _grad(lambda t: k5.flow_step_reverse_bf16_plain(t, rec, pb, 64),
                x, up)
    assert cs.within(served, twin, tol)[0]
    ok, max_abs, _ = cs.within(old, twin, tol)
    assert not ok and float((old - twin).abs().mean()) > 5 * tol["mean"]
    assert max_abs > 0


@pytest.fixture(scope="module")
def twin_step_values():
    """The twin path's loss and gradients on a batch, and under LQ x (1 +-
    GRAD_NUDGE), and the gradients of another batch, for each loss
    weighting."""
    model, prior = build_srflow_prior_trainer("cpu", seed=0, tiny=True)
    batches = [example_srflow_train_batch("cpu", seed=s, batch=2,
                                          gt_size=32) for s in (0, 1)]
    out = {}
    for image_weight in (0.0, 1.0):
        twin = cs.srflow_train_step(model, prior, image_weight, kernels=False)
        ref, ref_grads, _ = twin.loss_and_grads(batches[0])
        nudged = [twin.loss_and_grads(dict(
            batches[0], LQ=batches[0]["LQ"] * (1 + s * cs.GRAD_NUDGE)))[1]
            for s in (1, -1)]
        other = twin.loss_and_grads(batches[1])[1]
        out[image_weight] = ref, ref_grads, nudged, other
    return out


@pytest.mark.parametrize("image_weight", [0.0, 1.0])
def test_the_step_check_rejects_a_zero_and_a_wrong_gradient(
        twin_step_values, image_weight):
    ref, ref_grads, nudged, other = twin_step_values[image_weight]

    def hold(grads):
        cs.hold_step("srflow train step", ref, grads, ref, ref_grads, nudged,
                     "LQ x (1 +- 1e-7)")

    hold(ref_grads)
    hold(nudged[0])
    wrong = {
        "zero": {k: torch.zeros_like(v) for k, v in ref_grads.items()},
        "another batch's": other,
        "negated": {k: -v for k, v in ref_grads.items()},
        "twice": {k: 2 * v for k, v in ref_grads.items()},
    }
    for name, grads in wrong.items():
        with pytest.raises(RuntimeError, match="gradients past"):
            hold(grads)
        assert cs.global_rel_l2(grads, ref_grads) > cs.GRAD_CAP, name
