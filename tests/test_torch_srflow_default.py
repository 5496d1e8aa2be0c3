"""Port parity for SRFlow-LP under ``BFSR_PRECISION=default``: K5's two
one-pass (bf16) forms, their packed weights, the conditioning records and
the flow's encode / decode, each against the JAX package in the same mode.

Tolerances.  The ``pallas`` form's twin is held tight (1e-4 abs + 1e-4
rel) to the Pallas kernel at passes=1 in interpret mode on a step and
inputs drawn on a coarse dyadic grid (``_dyadic_case``): both round the
same five operands to bf16 and multiply exactly, and there every sum that
feeds a bf16 rounding is exact in f32, so the two round the same values
whatever the order of their sums.  On random inputs the two sums run in
different orders (which even vary between processes), so a rounding at a
tie can flip: that case is held at the tie-flip tolerance the kernels'
card tests use (2e-2 max, 1e-4 mean; ``PERF.md`` section 2).  The ``xla``
form's twin (the served one) is held to the port's unfused ``FlowStep``
in the same mode at 1e-4 abs + 1e-4 rel: both round the operands of conv1,
conv2 and conv3 only, keep the folds f32 and apply the gain after conv3,
so they too differ only in sum order.  The rest is loose: on the
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


LN2 = np.float32(np.log(2.0))


def _grid(g, shape, q, k):
    """float32 values q * n, n uniform in [-k, k]."""
    return (q * g.integers(-k, k + 1, shape)).astype(np.float32)


def _dyadic_case(c, h, w, seed):
    """A step (JAX params), state and conditioning cache on a coarse
    dyadic grid, so that every sum feeding one of the ``pallas`` form's
    bf16 roundings is exact in f32 in any order.  The invconv is a signed
    permutation, the actnorm scales exp(logs) are powers of two (exact in
    both packages' exp), the Conv2dZeros gain is 1, every weight is a
    bf16 value with few bits, and the state and the records are
    multiples of 1/8 or 1/4.  The magnitudes keep every partial sum of
    conv1, conv2 and conv3 under 2^24 of its products' quantum."""
    g = np.random.default_rng(seed)
    hid, cn = 64, c // 2
    p = jax.tree_util.tree_map(np.array, _mk_step(jax.random.PRNGKey(seed),
                                                  c))
    p["actnorm"] = {"bias": _grid(g, (c,), 0.25, 2),
                    "logs": LN2 * g.integers(0, 2, c).astype(np.float32)}
    wq = np.zeros((c, c), np.float32)
    wq[np.arange(c), g.permutation(c)] = g.choice([-1.0, 1.0], c)
    p["invconv"] = jflows.invconv_cache(wq)
    p["anic"] = jflows.fold_actnorm_invconv(p["actnorm"], p["invconv"])
    aff = p["affine"]["fAffine"]
    aff["conv1"]["w"][:, :, :cn] = _grid(g, (3, 3, cn, hid), 0.125, 1)
    aff["conv2"]["w"] = _grid(g, (1, 1, hid, hid), 0.125, 1)
    for conv in ("conv1", "conv2"):
        aff[conv]["actnorm"] = {
            "bias": _grid(g, (hid,), 0.25, 2),
            "logs": -LN2 * g.integers(0, 2, hid).astype(np.float32)}
    co2 = aff["out"]["b"].shape[0]
    aff["out"] = {"w": _grid(g, (3, 3, hid, co2), 2.0 ** -5, 1),
                  "b": _grid(g, (co2,), 0.125, 2),
                  "logs": np.zeros(co2, np.float32)}
    x = _grid(g, (1, h, w, c), 0.25, 8)
    cache = {"scale_ft": g.choice([0.5, 1.0], (1, h, w, c)).astype(np.float32),
             "shift_ft": _grid(g, (1, h, w, c), 0.25, 4),
             "aff1_ft": _grid(g, (1, h, w, hid), 0.125, 8)}
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return to_j(p), to_j(x), to_j(cache)


def _pallas_form_against_kernel(p, x, cache, c, h, w):
    """(forward, reverse) of the ``pallas`` form's twin through the
    wrappers, and of the JAX Pallas kernel at passes=1 in interpret mode,
    the reverse on the kernel's forward output; checks that the wrappers
    ran the twin and that the form rounded."""
    prep = fsk.prep_step(p, c, phases=1)
    cp = fsk.pack_cache(cache, h, w)
    zf = fsk.step_apply(fsk.pad_state(x), cp, prep, h, w, interpret=True)
    zr = fsk.step_apply(zf, cp, prep, h, w, reverse=True, interpret=True)
    ref_f = _np(fsk.unpad_state(zf, h, w, c))
    ref_r = _np(fsk.unpad_state(zr, h, w, c))
    step = port_step(p, c)
    pb = k5.pack_step_bf16(step.actnorm, step.invconv, step.affine, "pallas")
    rec, xt = record(cache), torch.from_numpy(_np(x))
    yt = torch.from_numpy(ref_f)
    got_f = k5.flow_step_forward(xt, rec, step.kpacked, 64, pb, "pallas")
    got_r = k5.flow_step_reverse(yt, rec, step.kpacked, 64, pb, "pallas")
    # the wrappers ran the pallas form's twin
    np.testing.assert_array_equal(
        got_f.numpy(),
        k5.flow_step_forward_bf16_pallas_plain(xt, rec, pb, 64).numpy())
    # the form rounded: it is off the f32 step by far more than f32 noise
    f32_f = k5.flow_step_forward_plain(xt, rec, step.kpacked, 64)
    f32_r = k5.flow_step_reverse_plain(yt, rec, step.kpacked, 64)
    assert float((got_f - f32_f).abs().max()) > 1e-3
    assert float((got_r - f32_r).abs().max()) > 1e-3
    return (got_f.numpy(), ref_f), (got_r.numpy(), ref_r)


@pytest.mark.parametrize("c,h,w", [(12, 9, 7), (24, 7, 10), (96, 5, 6)])
def test_k5_one_pass_twin_matches_pallas_kernel_interpret(restore_modes, c,
                                                          h, w):
    """On the dyadic step and inputs both sides round the same values:
    only the order of exact sums and f32 elementwise ops differ."""
    p, x, cache = _dyadic_case(c, h, w, seed=c)
    _set_both("default")
    for got, ref in _pallas_form_against_kernel(p, x, cache, c, h, w):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,h,w", [(12, 9, 7), (24, 7, 10), (96, 5, 6)])
def test_k5_one_pass_twin_matches_pallas_kernel_interpret_random(
        restore_modes, c, h, w):
    """On a random step and inputs a sum taken in another order can flip
    a bf16 rounding at a tie: held at 2e-2 max and 1e-4 mean."""
    p, _, x, cache = _case(c, h, w, seed=c)
    _set_both("default")
    for got, ref in _pallas_form_against_kernel(p, x, cache, c, h, w):
        err = np.abs(got - ref)
        assert err.max() <= 2e-2, err.max()
        assert err.mean() <= 1e-4, err.mean()


def test_packed_step_bf16_layout():
    """The ``pallas`` form's buffer: the f32 buffer's weights (gain folded
    into W3 and b3) with the folds, W1, W2 and W3 rounded once."""
    c, hid = 24, 64
    p, _, _, _ = _case(c, 4, 4, seed=2)
    step = port_step(p, c)
    pb = k5.pack_step_bf16(step.actnorm, step.invconv, step.affine, "pallas")
    f32 = k5.unpack_step(step.kpacked, c, hid)
    bf16 = k5.unpack_step_bf16(pb, c, hid, form="pallas")
    assert pb.dtype == torch.bfloat16
    assert pb.numel() == k5._packed_numel(c, hid, "pallas")
    assert set(bf16) == set(f32)
    for k in ("w_fold", "w_inv_fold", "w1", "w2", "w3"):   # rounded once
        torch.testing.assert_close(bf16[k], tnn.round_bf16(f32[k]), rtol=0,
                                   atol=0)
        assert not torch.equal(bf16[k], f32[k])
    for k in ("b_fold", "an_bias", "an1_b", "an1_e", "an2_b", "an2_e", "b3"):
        assert torch.equal(bf16[k], f32[k]), k            # f32, bit for bit
    # W3's columns padded from 2co = 24 to 32 with zeros, in the buffer
    n = pb.numel()
    w3 = pb[n - 9 * hid * 32:].reshape(9, hid, 32)
    assert not w3[..., 24:].any()
    with pytest.raises(ValueError):
        k5.unpack_step_bf16(pb, c, 32, form="pallas")
    with pytest.raises(ValueError):                       # the f32 buffer
        k5.unpack_step_bf16(step.kpacked, c, hid, form="pallas")
    with pytest.raises(ValueError):                       # the other form
        k5.unpack_step_bf16(pb, c, hid)
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
    """Encode and decode with ``kernels=True`` (the ``pallas`` form's twin
    on every conditional step, the flow frozen in that form for the test)
    against the JAX flow with the Pallas kernel at passes=1 on every
    conditional step, in interpret mode (jitted once)."""
    jm, _, tm, _ = tiny_pair()
    lr = np.random.default_rng(0).random((1, 6, 10, 3)).astype(np.float32)
    _set_both("default")
    tm.flowUpsamplerNet.freeze("pallas")
    try:
        _encode_decode_against_kernel_ctx(jm, tm, lr)
    finally:
        tm.flowUpsamplerNet.freeze()


def _encode_decode_against_kernel_ctx(jm, tm, lr):

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


def test_packed_step_bf16_xla_layout():
    """The served (``xla``) form's buffer: the folds and every vector f32
    bit for bit, W1 and W2 rounded, W3 and b3 unscaled (W3 rounded) and the
    gain ``exp(3 logs)`` as a vector, in the [scales | shifts] order."""
    c, hid = 24, 64
    p, _, _, _ = _case(c, 4, 4, seed=2)
    step = port_step(p, c)
    assert step.step_form == "xla"
    pb = step.kpacked_bf16
    assert pb.numel() == k5._packed_numel(c, hid, "xla")
    assert pb.numel() != k5._packed_numel(c, hid, "pallas")
    got = k5.unpack_step_bf16(pb, c, hid)
    parts = k5._step_parts(step.actnorm, step.invconv, step.affine)
    assert set(got) == set(parts)
    for k in ("w1", "w2", "w3"):
        want = tnn.round_bf16(parts[k].float()).reshape(got[k].shape)
        assert torch.equal(got[k], want), k
    for k in ("w_fold", "w_inv_fold", "b_fold", "an_bias", "an1_b", "an1_e",
              "an2_b", "an2_e", "b3", "g3"):
        assert torch.equal(got[k], parts[k].float().reshape(got[k].shape)), k
    out = step.affine.fAffine[4]
    gain = torch.exp(out.logs.reshape(-1) * 3.0)
    torch.testing.assert_close(got["g3"], torch.cat([gain[1::2], gain[0::2]]),
                               rtol=0, atol=0)
    assert not torch.equal(got["g3"], torch.ones_like(got["g3"]))
    # b3, g3 and W3 padded from 2co = 24 to 32 columns with zeros
    nw = k5._f32_words(c, hid)
    words = pb[:2 * nw].view(torch.float32)
    off = 2 * c + 4 * hid
    assert not words[off + 24:off + 32].any()            # b3's pad
    assert not words[off + 32 + 24:off + 64].any()       # g3's pad
    w3 = pb[pb.numel() - 9 * hid * 32:].reshape(9, hid, 32)
    assert not w3[..., 24:].any()


@pytest.mark.parametrize("c,h,w", [(12, 9, 7), (24, 7, 10), (96, 5, 6)])
def test_k5_xla_twin_matches_unfused_step(restore_modes, c, h, w):
    """The served form's twin against the port's unfused ``FlowStep``
    (``kernels=False``: the fold f32, the tower through ``fnn.conv2d``)
    under ``default``: the same operands rounded, so sum order only (1e-4
    abs + 1e-4 rel).  The gain's place matters: a twin that folds the gain
    into W3 before rounding W3 (as the Pallas kernel does) is off the
    unfused step by far more."""
    p, _, x, cache = _case(c, h, w, seed=c + 1)
    step = port_step(p, c)
    rec, xt = record(cache), torch.from_numpy(_np(x))
    tnn.set_default_precision("default")
    with torch.no_grad():
        _xla_twin_against_unfused(step, xt, rec, c)


def _xla_twin_against_unfused(step, xt, rec, c):
    ref_f = step.forward_step(xt, rec, kernels=False)
    got_f = k5.flow_step_forward(xt, rec, step.kpacked, 64, step.kpacked_bf16)
    np.testing.assert_allclose(got_f.numpy(), ref_f.numpy(), atol=1e-4,
                               rtol=1e-4)
    ref_r = step.reverse_step(ref_f, rec, kernels=False)
    got_r = k5.flow_step_reverse(ref_f, rec, step.kpacked, 64,
                                 step.kpacked_bf16)
    np.testing.assert_allclose(got_r.numpy(), ref_r.numpy(), atol=1e-4,
                               rtol=1e-4)
    # the gain folded into W3 before rounding: round(W3 g) for round(W3) g
    pw = k5.unpack_step_bf16(step.kpacked_bf16, c, 64)
    parts = k5._fold_gain(k5._step_parts(step.actnorm, step.invconv,
                                         step.affine))
    folded = {**{k: v for k, v in pw.items() if k != "g3"},
              "w3": tnn.round_bf16(parts["w3"].float()).reshape(9, 64, -1),
              "b3": parts["b3"].float()}
    off_f = k5._forward(xt, rec, folded, tnn.round_bf16)
    assert float((off_f - ref_f).abs().max()) > 1e-3
