"""Port parity: the K3 twins (conv3x3_cat_plain, and conv3x3_cat_bf16_plain
for the one-pass bf16 form) against the JAX s2d Pallas conv (interpret
mode, through space_to_depth and space_to_depth_h) and fnn.conv2d on an
explicit concat; K6 (conv3x3_fused) against the JAX conv3x3_fused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.ops import nn as jnn
from bfsr_tpu.ops.pallas import s2d_conv as s2d
from bfsr_tpu.ops.pallas.conv3x3 import conv3x3_fused as j_conv3x3_fused
from bfsr_tpu.ops.pallas.conv3x3 import fold_bn as j_fold_bn
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import (conv3x3_cat, conv3x3_cat_bf16,
                                             conv3x3_cat_bf16_plain,
                                             conv3x3_cat_plain,
                                             conv3x3_fused, kernel_weight)

CINS = [3, 5, 4, 6, 2]


def _case(rng, n_in, H, W, cout, with_scale):
    xs = [rng.standard_normal((1, H, W, c)).astype(np.float32)
          for c in CINS[:n_in]]
    cin = sum(CINS[:n_in])
    w = (0.3 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    scale = (rng.random(cout) + 0.5).astype(np.float32) if with_scale else None
    bias = rng.standard_normal(cout).astype(np.float32)
    return xs, w, scale, bias


def _jax_ref(xs, w, scale, bias, act):
    y = jnn.conv2d(jnp.concatenate([jnp.asarray(x) for x in xs], -1),
                   {"w": jnp.asarray(w)}, precision=jax.lax.Precision.HIGHEST)
    if scale is not None:
        y = y * scale
    y = y + bias
    if act == "relu":
        y = jnn.relu(y)
    elif act == "lrelu":
        y = jnn.leaky_relu(y)
    return np.asarray(y)


def _port(fn, xs, w, scale, bias, act):
    t = torch.from_numpy
    return fn([t(x) for x in xs], t(w.transpose(3, 2, 0, 1).copy()),
              None if scale is None else t(scale), t(bias), act).numpy()


@pytest.mark.parametrize("n_in,act,with_scale", [
    (1, None, False), (2, "relu", True), (3, "lrelu", True),
    (5, "lrelu", False)])
def test_k3_twin_matches_s2d_kernel(rng, n_in, act, with_scale):
    xs, w, scale, bias = _case(rng, n_in, 8, 12, 8, with_scale)
    got = _port(conv3x3_cat_plain, xs, w, scale, bias, act)
    split = CINS[:n_in]
    out = s2d.conv3x3_s2d(
        [s2d.space_to_depth(jnp.asarray(x)) for x in xs],
        s2d.s2d_weight(jnp.asarray(w), cin_split=split),
        scale=None if scale is None else jnp.asarray(scale),
        bias=jnp.asarray(bias), act=act, interpret=True)
    np.testing.assert_allclose(got, np.asarray(s2d.depth_to_space(out)),
                               atol=1e-4)
    np.testing.assert_allclose(got, _jax_ref(xs, w, scale, bias, act),
                               atol=2e-5)


@pytest.mark.parametrize("n_in,act,with_scale,H,W", [
    (1, "relu", False, 7, 9), (4, None, True, 5, 13), (5, "lrelu", True, 6, 11)])
def test_k3_twin_matches_xla_conv_odd_extent(rng, n_in, act, with_scale, H, W):
    xs, w, scale, bias = _case(rng, n_in, H, W, 16, with_scale)
    got = _port(conv3x3_cat_plain, xs, w, scale, bias, act)
    np.testing.assert_allclose(got, _jax_ref(xs, w, scale, bias, act),
                               atol=2e-5)
    # on CPU tensors the dispatching wrapper is the twin
    np.testing.assert_array_equal(
        _port(conv3x3_cat, xs, w, scale, bias, act), got)


def test_fold_bn_matches_jax(rng):
    c = 6
    bn = torch.nn.BatchNorm2d(c).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.random(c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.random(c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.random(c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.random(c).astype(np.float32)
                                              + 0.5))
    jbn = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy(),
           "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    conv_b = rng.random(c).astype(np.float32)
    for b in (None, conv_b):
        js, jb = j_fold_bn({} if b is None else {"b": jnp.asarray(b)},
                           jax.tree_util.tree_map(jnp.asarray, jbn))
        ts, tb = tnn.fold_bn(bn, None if b is None else torch.from_numpy(b))
        np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                                   rtol=1e-6)
        np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb),
                                   rtol=1e-6, atol=1e-7)


def test_k3_wrapper_validates_inputs(rng):
    xs, w, _, bias = _case(rng, 2, 4, 4, 8, False)
    t = [torch.from_numpy(x) for x in xs]
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    with pytest.raises(ValueError):
        conv3x3_cat(t[:1], wt)           # weight Cin mismatch
    with pytest.raises(ValueError):
        conv3x3_cat(t, wt, act="gelu")
    with pytest.raises(ValueError):
        conv3x3_cat(t * 3, torch.zeros(8, 48, 3, 3))  # > 5 inputs


def test_kernel_weight_holds_each_inputs_block(rng):
    """Input i's weight starts sum(cins[:i]) * 9 * Cout floats into
    kernel_weight(w), as (Ci, 3, 3, Cout): the offsets the K3 wrapper
    passes to conv3x3.cu."""
    cins, cout = CINS, 8
    w = torch.from_numpy(rng.standard_normal((cout, sum(cins), 3, 3))
                         .astype(np.float32))
    flat = kernel_weight(w).reshape(-1)
    off = 0
    for ci in cins:
        block = flat[off * 9 * cout:(off + ci) * 9 * cout].reshape(ci, 3, 3,
                                                                   cout)
        torch.testing.assert_close(
            block, w[:, off:off + ci].permute(1, 2, 3, 0), rtol=0, atol=0)
        off += ci


@pytest.mark.parametrize("cins,cout,H,W,act,with_scale,phases", [
    ([3], 16, 8, 12, "relu", False, 4),
    ([3, 32, 32], 32, 6, 10, "lrelu", False, 4),
    ([5, 3, 17, 6, 35], 8, 10, 6, None, True, 4),
    ([64, 64], 64, 4, 14, "lrelu", True, 2),
    ([6, 64, 20], 16, 12, 6, None, False, 2)])
def test_bf16_twin_matches_s2d_kernel_one_pass(rng, cins, cout, H, W, act,
                                               with_scale, phases):
    """K3 at passes=1: the JAX kernel rounds both operands to bf16 and
    accumulates in f32 (interpret mode on the CPU), as the bf16 twin does,
    so the two differ only in the order of the f32 sums.  Multi-input
    concats with channel blocks that are not multiples of 16, in the full
    2x2 and the H-only s2d domains."""
    xs = [rng.standard_normal((1, H, W, c)).astype(np.float32) for c in cins]
    w = (0.3 * rng.standard_normal((3, 3, sum(cins), cout))).astype(np.float32)
    scale = (rng.random(cout) + 0.5).astype(np.float32) if with_scale else None
    bias = rng.standard_normal(cout).astype(np.float32)
    got = _port(conv3x3_cat_bf16_plain, xs, w, scale, bias, act)
    to_s2d, back, factors = ((s2d.space_to_depth, s2d.depth_to_space, (2, 2))
                             if phases == 4 else
                             (s2d.space_to_depth_h, s2d.depth_to_space_h,
                              (2, 1)))
    out = s2d.conv3x3_s2d(
        [to_s2d(jnp.asarray(x)) for x in xs],
        s2d.s2d_weight(jnp.asarray(w), cin_split=cins, factors=factors),
        scale=None if scale is None else jnp.asarray(scale),
        bias=jnp.asarray(bias), act=act, passes=1, phases=phases,
        interpret=True)
    ref = np.asarray(back(out))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the dispatching bf16 wrapper is the twin on CPU tensors
    np.testing.assert_array_equal(
        _port(conv3x3_cat_bf16, xs, w, scale, bias, act), got)
    # and the one-pass form is the bf16 one, not the f32 conv
    assert np.abs(got - _jax_ref(xs, w, scale, bias, act)).max() > 1e-4


def _j_hwio(w_oihw):
    return jnp.asarray(np.ascontiguousarray(w_oihw.transpose(2, 3, 1, 0)))


def test_k6_matches_jax_conv3x3_fused(rng):
    """tests/test_pallas_conv.py's three cases: Cout 16 plain, Cout 8 with
    a folded BatchNorm and LeakyReLU, Cout 4 with a conv bias."""
    t = torch.from_numpy
    x = rng.random((1, 16, 12, 8)).astype(np.float32)
    w = (rng.random((16, 8, 3, 3)) - 0.5).astype(np.float32)
    ref = j_conv3x3_fused(jnp.asarray(x), _j_hwio(w), interpret=True)
    np.testing.assert_allclose(conv3x3_fused(t(x), t(w)).numpy(),
                               np.asarray(ref), atol=2e-5)

    x = rng.random((1, 8, 8, 4)).astype(np.float32)
    w = (rng.random((8, 4, 3, 3)) - 0.5).astype(np.float32)
    bn = {k: jnp.asarray(rng.random(8).astype(np.float32) + off)
          for k, off in (("scale", 0.5), ("bias", 0.0), ("mean", 0.0),
                         ("var", 0.5))}
    js, jb = j_fold_bn({"w": _j_hwio(w)}, bn)
    ref = j_conv3x3_fused(jnp.asarray(x), _j_hwio(w), scale=js, bias=jb,
                          act="lrelu", interpret=True)
    got = conv3x3_fused(t(x), t(w), t(np.array(js)), t(np.array(jb)),
                        "lrelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)

    x = rng.random((1, 10, 6, 3)).astype(np.float32)
    w = (rng.random((4, 3, 3, 3)) - 0.5).astype(np.float32)
    b = rng.random(4).astype(np.float32)
    ref = j_conv3x3_fused(jnp.asarray(x), _j_hwio(w), bias=jnp.asarray(b),
                          interpret=True)
    np.testing.assert_allclose(conv3x3_fused(t(x), t(w), bias=t(b)).numpy(),
                               np.asarray(ref), atol=2e-5)


def test_k6_stays_f32_in_every_mode(rng):
    """K6 reads no mode: under ``default`` it is still the f32 twin."""
    t = torch.from_numpy
    x = t(rng.standard_normal((1, 7, 9, 5)).astype(np.float32))
    w = t(rng.standard_normal((100, 5, 3, 3)).astype(np.float32))
    want = conv3x3_cat_plain([x], w)
    saved = tnn.precision_mode()
    try:
        tnn.set_default_precision("default")
        got = conv3x3_fused(x, w)
    finally:
        tnn.set_default_precision(saved)
    assert got.shape == (1, 7, 9, 100)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
