"""Port parity for SRFlow-LP under ``BFSR_PRECISION=default``: K5's one-pass
(bf16) form, its packed weights, the conditioning records and the flow's
encode / decode, each against the JAX package in the same mode.

Tolerances.  The one-pass twin is held tight (1e-4 abs + 1e-4 rel) to the
Pallas kernel at passes=1 in interpret mode: both round the same five
operands to bf16 and multiply exactly, and differ only in the order of
their f32 sums (7.2e-7 at most at these shapes).  The rest is loose: on the
CPU, XLA ignores ``Precision.DEFAULT``, so the JAX conditioning records,
RRDB and split conv are f32 where the port rounds their operands to bf16
(records 3e-2, epses 2e-2, the decoded image 5e-2; measured 1.0e-2, 4.1e-3
and 1.3e-2).  Every test restores both packages' modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.ops import flows as jflows
from bfsr_tpu.ops import nn as jnn
from bfsr_tpu.ops.interp import resize_bilinear as j_resize
from bfsr_tpu.ops.pallas import flow_step as fsk
from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.ops.cuda import flow_step as k5
from bfsr_tpu_torch.ops.interp import resize_bilinear

from test_flow_step_kernel import _mk_step
from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_srflow_models import tiny_pair
from test_torch_srflow_step import _case, _np, port_step, record


def _set_both(mode):
    tnn.set_default_precision(mode)
    jnn.set_default_precision(mode)


@pytest.mark.parametrize("c,h,w", [(12, 9, 7), (24, 7, 10), (96, 5, 6)])
def test_k5_one_pass_twin_matches_pallas_kernel_interpret(restore_modes, c,
                                                          h, w):
    p, _, x, cache = _case(c, h, w, seed=c)
    _set_both("default")
    prep = fsk.prep_step(p, c, phases=1)
    cp = fsk.pack_cache(cache, h, w)
    zf = fsk.step_apply(fsk.pad_state(x), cp, prep, h, w, interpret=True)
    zr = fsk.step_apply(zf, cp, prep, h, w, reverse=True, interpret=True)
    ref_f = _np(fsk.unpad_state(zf, h, w, c))
    ref_r = _np(fsk.unpad_state(zr, h, w, c))
    step = port_step(p, c)
    rec, xt = record(cache), torch.from_numpy(_np(x))
    got_f = k5.flow_step_forward(xt, rec, step.kpacked, 64, step.kpacked_bf16)
    np.testing.assert_allclose(got_f.numpy(), ref_f, atol=1e-4, rtol=1e-4)
    yt = torch.from_numpy(ref_f)
    got_r = k5.flow_step_reverse(yt, rec, step.kpacked, 64, step.kpacked_bf16)
    np.testing.assert_allclose(got_r.numpy(), ref_r, atol=1e-4, rtol=1e-4)
    # the wrappers ran the one-pass twin
    np.testing.assert_array_equal(got_f.numpy(), k5.flow_step_forward_bf16_plain(
        xt, rec, step.kpacked_bf16, 64).numpy())
    # the form rounded: it is off the f32 step by far more than f32 noise
    f32_f = k5.flow_step_forward_plain(xt, rec, step.kpacked, 64)
    f32_r = k5.flow_step_reverse_plain(yt, rec, step.kpacked, 64)
    assert float((got_f - f32_f).abs().max()) > 1e-3
    assert float((got_r - f32_r).abs().max()) > 1e-3


def test_packed_step_bf16_layout():
    c, hid = 24, 64
    p, _, _, _ = _case(c, 4, 4, seed=2)
    step = port_step(p, c)
    f32 = k5.unpack_step(step.kpacked, c, hid)
    bf16 = k5.unpack_step_bf16(step.kpacked_bf16, c, hid)
    assert step.kpacked_bf16.dtype == torch.bfloat16
    assert set(bf16) == set(f32)
    for k in ("w_fold", "w_inv_fold", "w1", "w2", "w3"):   # rounded once
        torch.testing.assert_close(bf16[k], tnn.round_bf16(f32[k]), rtol=0,
                                   atol=0)
        assert not torch.equal(bf16[k], f32[k])
    for k in ("b_fold", "an_bias", "an1_b", "an1_e", "an2_b", "an2_e", "b3"):
        assert torch.equal(bf16[k], f32[k]), k            # f32, bit for bit
    # W3's columns padded from 2co = 24 to 32 with zeros, in the buffer
    n = step.kpacked_bf16.numel()
    w3 = step.kpacked_bf16[n - 9 * hid * 32:].reshape(9, hid, 32)
    assert not w3[..., 24:].any()
    with pytest.raises(ValueError):
        k5.unpack_step_bf16(step.kpacked_bf16, c, 32)
    with pytest.raises(ValueError):                       # the f32 buffer
        k5.unpack_step_bf16(step.kpacked, c, hid)
    x = torch.zeros((1, 3, 3, c))
    rec = torch.zeros((1, 3, 3, 2 * c + hid))
    with pytest.raises(ValueError):                       # none given
        k5.flow_step_forward_bf16_plain(x, rec, None, hid)


def test_k5_form_follows_the_stage(restore_modes):
    c, h, w = 12, 5, 4
    p, _, x, cache = _case(c, h, w, seed=3)
    step = port_step(p, c)
    rec, xt = record(cache), torch.from_numpy(_np(x))
    args = (xt, rec, step.kpacked, 64, step.kpacked_bf16)
    f32 = k5.flow_step_forward_plain(xt, rec, step.kpacked, 64)
    bf16 = k5.flow_step_forward_bf16_plain(xt, rec, step.kpacked_bf16, 64)
    for mode, stage, want in (("high", None, f32), ("mixed", None, f32),
                              ("mixed", "prior", bf16),
                              ("default", None, bf16)):
        tnn.set_default_precision(mode)
        with tnn.stage(stage):
            assert torch.equal(k5.flow_step_forward(*args), want), (mode,
                                                                     stage)
    tnn.set_default_precision("default")
    with pytest.raises(ValueError, match="kpacked_bf16"):
        k5.flow_step_reverse(xt, rec, step.kpacked, 64)


def test_default_records_match_jax_and_round_only_in_bf16_stages(
        restore_modes):
    key = jax.random.PRNGKey(4)
    c, h, w = 12, 10, 7
    ps = [_mk_step(jax.random.fold_in(key, i), c, c_cond=40, hidden=16)
          for i in range(3)]
    ft = jax.random.normal(jax.random.fold_in(key, 9), (1, h, w, 40))
    steps = [port_step(p, c, c_cond=40, hidden=16) for p in ps]
    ftt = torch.from_numpy(_np(ft))
    _set_both("default")
    ref = jflows.cond_affine_cache_batched(ft, [p["affine"] for p in ps])
    got = {"default": flows.cond_affine_cache_batched(
        ftt, [s.affine for s in steps])}
    for g, r in zip(got["default"], ref):
        np.testing.assert_allclose(g.numpy(), record(r).numpy(), atol=3e-2)
    for mode in ("high", "highest", "mixed"):
        tnn.set_default_precision(mode)
        got[mode] = flows.cond_affine_cache_batched(ftt,
                                                    [s.affine for s in steps])
    with tnn.stage("prior"):                    # a bf16 stage under mixed
        prior = flows.cond_affine_cache_batched(ftt, [s.affine for s in steps])
    for i in range(3):
        assert torch.equal(got["high"][i], got["highest"][i])
        assert torch.equal(got["high"][i], got["mixed"][i])
        assert torch.equal(prior[i], got["default"][i])
        assert float((got["default"][i] - got["high"][i]).abs().max()) > 1e-3


def test_encode_decode_default_matches_jax_kernel_ctx(restore_modes):
    """Encode and decode with ``kernels=True`` (the one-pass twin on every
    conditional step) against the JAX flow with the Pallas kernel at
    passes=1 on every conditional step, in interpret mode (jitted once)."""
    jm, _, tm, _ = tiny_pair()
    lr = np.random.default_rng(0).random((1, 6, 10, 3)).astype(np.float32)
    _set_both("default")

    def run(params, jlr):
        enc = jm.preprocess(params, jlr)
        ftc = jm.precompute_ft(params, enc)
        kctx = jm.prep_kernel_ctx(params, ftc, interpret=True)
        epses, _, _ = jm.normal_flow(params, j_resize(jlr, (24, 40)), jlr,
                                     add_gt_noise=False, lr_enc=enc,
                                     ft_cache=ftc, want_logdet=False,
                                     kernel_ctx=kctx)
        sr, _ = jm.reverse_flow(params, jlr, epses=epses, add_gt_noise=False,
                                lr_enc=enc, ft_cache=ftc, want_logdet=False,
                                kernel_ctx=kctx)
        return epses, sr

    ref_e, ref_sr = jax.jit(run)(jm.params, jnp.asarray(lr))
    t = torch.from_numpy(lr)
    with torch.no_grad():
        cache = tm.precompute_ft(tm.rrdb_preprocess(t))
        got = tm.normal_flow(resize_bilinear(t, (24, 40)), cache)
        assert [tuple(e.shape) for e in got] == [(1, 12, 20, 6), (1, 3, 5, 96)]
        for g, r in zip(got, ref_e):
            np.testing.assert_allclose(g.numpy(), _np(r), atol=2e-2)
        sr = tm.reverse_flow([torch.from_numpy(_np(r)) for r in ref_e], cache)
    np.testing.assert_allclose(sr.numpy(), _np(ref_sr), atol=5e-2)
