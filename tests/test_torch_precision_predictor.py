"""Port parity under the bf16 serving modes: the EDSR encoder, the LINF-LP
predictor under ``mixed`` and ``default`` and SRFlow-LP under ``mixed``
and ``default``, each against the JAX package in the same mode on the
same weights; the conv probe (P1-P3) on the CPU.

Tolerances.  The EDSR check is tight (1e-4): on the JAX side every conv is
the s2d Pallas kernel at passes=1 in interpret mode, which rounds both
operands to bf16 explicitly, as the port's bf16 twin does.  The predictor
checks are loose (5e-2): XLA on the CPU ignores ``Precision.DEFAULT`` for
the convs outside the Pallas kernels (the JAX encoder's XLA form, the
head, the UNet's mid-resolution convs and its LR projection, the SRFlow
prior), which the port rounds to bf16, so the two sides differ there by
bf16 rounding.  Every test restores both packages' modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.models.edsr import edsr_apply_fused
from bfsr_tpu.ops import nn as jnn
from bfsr_tpu.pipelines.linf_eval import LINFPredictor as JLINFPredictor
from bfsr_tpu.pipelines.srflow_eval import SRFlowLPPredictor as JSRFlowPredictor
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor, pad_to_even
from bfsr_tpu_torch.profiling import conv_probe, mode_agreement

from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_predictor import _inputs, _models
from test_torch_srflow_models import tiny_pair


def _set_both(mode):
    tnn.set_default_precision(mode)
    jnn.set_default_precision(mode)


@pytest.mark.parametrize("h,w", [(6, 7), (8, 5)])
def test_edsr_default_matches_fused_one_pass(rng, restore_modes, h, w):
    """Every encoder conv on K3 at passes=1 (JAX) and on the bf16 twin
    (port): the 2-block tiny encoder, 5 convs."""
    jm, _, tm, _ = _models()
    x = rng.random((1, h, w, 3)).astype(np.float32)
    _set_both("default")
    ref = np.asarray(edsr_apply_fused(jm.params["encoder"], jnp.asarray(x)))
    got = {k: tm.gen_feat(torch.from_numpy(x), kernels=k).detach().numpy()
           for k in (True, False)}
    np.testing.assert_allclose(got[True], ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[False], got[True])
    _set_both("high")
    f32 = tm.gen_feat(torch.from_numpy(x)).detach().numpy()
    assert np.abs(f32 - ref).max() > 1e-4   # the mode did round


@pytest.mark.parametrize("mode", ["mixed", "default"])
def test_linf_predictor_matches_jax_in_mode(rng, restore_modes, mode):
    jm, jprior, tm, tprior = _models()
    h, w, s = 5, 6, 2
    H, W = h * s, w * s
    inp, coord, cell, gt = _inputs(rng, h, w, H, W)
    _set_both(mode)
    ref = np.asarray(JLINFPredictor(jm, jprior, tile_queries=32,
                                    use_pallas=True).predict(
        jm.params, jprior.params, jnp.asarray(inp), jnp.asarray(coord),
        jnp.asarray(cell), jnp.asarray(gt)))
    t = torch.from_numpy
    got = {k: LINFPredictor(tm, tprior, kernels=k).predict(
        t(inp), t(coord), t(cell), t(gt)).numpy() for k in (True, False)}
    np.testing.assert_allclose(got[True], ref, atol=5e-2)
    np.testing.assert_array_equal(got[False], got[True])
    _set_both("high")
    high = LINFPredictor(tm, tprior).predict(t(inp), t(coord), t(cell),
                                             t(gt)).numpy()
    assert 0 < np.abs(got[True] - high).max() < 5e-2


def test_srflow_predictor_matches_jax_under_mixed(rng, restore_modes):
    jm, jp, tm, tp = tiny_pair()
    lr = rng.random((8, 10, 3)).astype(np.float32)
    _set_both("mixed")
    ref = JSRFlowPredictor(jm, jp).predict(lr)
    got = {k: SRFlowLPPredictor(tm, tp, kernels=k).predict(
        torch.from_numpy(lr)).numpy() for k in (True, False)}
    assert got[True].shape == (32, 40, 3)
    np.testing.assert_allclose(got[True], ref, atol=5e-2)
    # the twin path runs the flow steps unfused: f32 sums in another order
    np.testing.assert_allclose(got[False], got[True], atol=1e-4)
    # only the prior went bf16: the unclipped output moved, a little
    x = torch.from_numpy(lr[None])
    mixed = SRFlowLPPredictor(tm, tp).run(x)
    _set_both("high")
    high = SRFlowLPPredictor(tm, tp).run(x)
    assert 0 < float((mixed - high).abs().max()) < 5e-2


@pytest.mark.parametrize("kernels", [True, False])
def test_srflow_predictor_matches_jax_under_default(rng, restore_modes,
                                                    kernels):
    """Every stage bf16.  The kernel path serves K5's ``xla`` one-pass form
    (its twin here) on each conditional step, the twin path the unfused
    steps: both keep the fold f32 and round only the coupling tower's
    operands, as the JAX predictor's XLA step does, so the two paths agree
    to f32 sum order (1e-4; 0.0 measured here, where the ``pallas`` form
    that rounds the state too is 2.1e-2 off).  Each is within 5e-2 of the
    JAX predictor and moved off ``high`` by bf16 rounding."""
    jm, jp, tm, tp = tiny_pair()
    lr = rng.random((7, 9, 3)).astype(np.float32)
    _set_both("default")
    ref = JSRFlowPredictor(jm, jp).predict(lr)
    got = SRFlowLPPredictor(tm, tp, kernels=kernels).predict(
        torch.from_numpy(lr)).numpy()
    assert got.shape == (28, 36, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=5e-2)
    x = pad_to_even(torch.from_numpy(lr))
    sr = SRFlowLPPredictor(tm, tp, kernels=kernels).run(x)
    other = SRFlowLPPredictor(tm, tp, kernels=not kernels).run(x)
    np.testing.assert_allclose(sr.numpy(), other.numpy(), atol=1e-4,
                               rtol=1e-4)
    if kernels:    # the Pallas kernel's numerics are another answer
        tm.flowUpsamplerNet.freeze("pallas")
        try:
            pallas = SRFlowLPPredictor(tm, tp).run(x)
        finally:
            tm.flowUpsamplerNet.freeze()
        assert float((pallas - other).abs().max()) > 1e-3
    _set_both("high")
    high = SRFlowLPPredictor(tm, tp, kernels=kernels).run(x)
    assert 0 < float((sr - high).abs().max()) < 5e-2


def test_conv_probe_runs_on_cpu():
    """The probe's one function at a small shape through the twin: the
    bf16 result against the f32 conv, times not measured on the CPU."""
    r = conv_probe.run("cpu", size=12, cin=64, cout=192)
    assert r["device"] == "cpu" and r["flops"] == 2 * 12 * 12 * 9 * 64 * 192
    assert r["twin_max_abs_err"] == 0.0
    assert 1e-5 < r["max_abs_err"] < 1e-2 * r["max_abs_ref"]
    assert r["ms"] is None and r["library_ms"] is None
    x, w = conv_probe.probe_inputs(4, 2, 3)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x, rng.random((1, 4, 4, 2))
                                  .astype(np.float32))
    np.testing.assert_array_equal(
        w, (rng.random((3, 3, 2, 3)) - 0.5).astype(np.float32) * 0.1)


def test_mode_agreement_runs_on_cpu(restore_modes):
    """bench.py's precision delta on the port's flagships (twins, LR 16):
    each mode near high, and the mode restored."""
    tnn.set_default_precision("highest")
    res = mode_agreement.run("cpu", lr=16)
    assert set(res) == {"linf mixed", "linf default", "srflow mixed",
                        "srflow default"}
    assert res["linf mixed"] > res["linf default"] > 50
    assert res["srflow mixed"] > res["srflow default"] > 45
    assert tnn.precision_mode() == "highest"
    a = torch.zeros(4)
    assert mode_agreement.agreement_db(a + 0.1, a) == pytest.approx(20.0)
