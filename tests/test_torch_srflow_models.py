"""Port parity: SRFlow-LP's RRDB conditioning, per-level conditioning
records, nearest resize and two-branch prior against the JAX package,
and the from_jax <-> convert_srflow / convert_srflow_unet weight bridge.

Tolerance: 5e-5 for every module (``docs/PARITY.md``'s module level);
exact for the nearest resize, which only moves values.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.convert.torch_import import convert_srflow, convert_srflow_unet
from bfsr_tpu.models.srflow import flow_upsampler as fup
from bfsr_tpu.models.srflow.srflow_net import rrdb_preprocess as j_preprocess
from bfsr_tpu.models.srflow.unet_prior import srflow_unet_apply
from bfsr_tpu.ops import interp as jinterp
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import (load_srflow, load_srflow_unet,
                                             srflow_state_dict,
                                             srflow_unet_state_dict)
from bfsr_tpu_torch.entry import srflow_specs
from bfsr_tpu_torch.models.srflow.flow_upsampler import build_plan
from bfsr_tpu_torch.models.srflow.srflow_net import rrdb_preprocess
from bfsr_tpu_torch.ops import interp as tinterp


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def live_flow(params, seed=11):
    """JAX SRFlow params with live random tails and actnorms (normal with
    std 0.08 / 0.05 / 0.1, as ``tests/test_flow_step_kernel.py``), so the
    couplings are not constants."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return jnp.asarray(rng.normal(0, std, shape), jnp.float32)

    def tail(p):
        return {"w": normal(p["w"].shape, 0.08),
                "b": normal(p["b"].shape, 0.05),
                "logs": normal(p["logs"].shape, 0.1)}

    def an(p):
        return {"bias": normal(p["bias"].shape, 0.1),
                "logs": normal(p["logs"].shape, 0.1)}

    layers = []
    for p in params["flow"]["layers"]:
        p = dict(p)
        if "actnorm" in p:
            p["actnorm"] = an(p["actnorm"])
        if "affine" in p:
            aff = {}
            for t in ("fFeatures", "fAffine"):
                tw = dict(p["affine"][t], out=tail(p["affine"][t]["out"]))
                for c in ("conv1", "conv2"):
                    tw[c] = dict(tw[c], actnorm=an(tw[c]["actnorm"]))
                aff[t] = tw
            p["affine"] = aff
        if "conv" in p:
            p["conv"] = tail(p["conv"])
        layers.append(p)
    return dict(params, flow={"layers": layers})


@functools.lru_cache(maxsize=1)
def tiny_pair():
    """(JAX SRFlowNet, JAX prior, port SRFlowNet, port prior) at the tiny
    config, the flow live, the prior's BN statistics non-trivial; the port
    carries the JAX weights through from_jax.  Built once per process;
    callers must not change them."""
    fs, ps = srflow_specs(tiny=True)
    jm = jregistry.make(fs)
    jm.params = live_flow(jm.params)
    jm.freeze()
    jp = jregistry.make(ps)
    jp.params = _prior_params(jp.params)
    tm = load_srflow(registry.make(fs), _np_tree(jm.params)).eval()
    tp = load_srflow_unet(registry.make(ps), _np_tree(jp.params)).eval()
    return jm, jp, tm, tp


def _prior_params(params, seed=2):
    """Perturb every BatchNorm of a JAX prior to non-trivial statistics."""
    rng = np.random.default_rng(seed)
    params = _np_tree(params)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                n = node["scale"].shape[0]
                node.update(
                    scale=(rng.random(n) + 0.5).astype(np.float32),
                    bias=(0.1 * rng.standard_normal(n)).astype(np.float32),
                    mean=(0.1 * rng.standard_normal(n)).astype(np.float32),
                    var=(rng.random(n) + 0.5).astype(np.float32))
            else:
                for v in node.values():
                    perturb(v)
        elif isinstance(node, list):
            for v in node:
                perturb(v)

    perturb(params)
    return params


@pytest.mark.parametrize("kernels", [True, False])
def test_rrdb_preprocess_matches_jax(rng, kernels):
    jm, _, tm, _ = tiny_pair()
    lr = rng.random((1, 6, 10, 3)).astype(np.float32)
    ref = j_preprocess(jm.params["rrdb"], jnp.asarray(lr), 4, (0, 1))
    keys = ("fea_up2", "fea_up1", "fea_up0")
    assert tm.cond_keys() == list(keys)
    with torch.no_grad():
        got = rrdb_preprocess(tm.RRDB, torch.from_numpy(lr), (0, 1), keys,
                              kernels=kernels)
    assert set(got) == {"block_0", "block_1", *keys}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), atol=5e-5,
                                   rtol=5e-5, err_msg=k)


def test_precompute_ft_matches_jax(rng):
    jm, _, tm, _ = tiny_pair()
    lr = rng.random((1, 6, 8, 3)).astype(np.float32)
    enc = jm.preprocess(jm.params, jnp.asarray(lr))
    ref = fup.precompute_ft(jm.params["flow"], jm.plan, jm._conds(enc),
                            lvl1_s2d=False)
    with torch.no_grad():
        got = tm.precompute_ft(tm.rrdb_preprocess(torch.from_numpy(lr)))
    n = 0
    for e, r, g in zip(tm.plan, ref, got):
        if e["kind"] != "step_cond":
            assert r is None and g is None
            continue
        c = e["c"]
        for i, k in enumerate(("scale_ft", "shift_ft")):
            np.testing.assert_allclose(g[..., i * c:(i + 1) * c].numpy(),
                                       np.asarray(r[k]), atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(g[..., 2 * c:].numpy(),
                                   np.asarray(r["aff1_ft"]), atol=5e-5,
                                   rtol=5e-5)
        n += 1
    assert n == 3 * 2


@pytest.mark.parametrize("kernels", [True, False])
def test_prior_matches_jax(rng, kernels):
    _, jp, _, tp = tiny_pair()
    e0 = rng.standard_normal((1, 12, 10, 6)).astype(np.float32)
    e1 = rng.standard_normal((1, 4, 6, 96)).astype(np.float32)
    ref = srflow_unet_apply(jp.params, [jnp.asarray(e0), jnp.asarray(e1)],
                            depth=2)
    with torch.no_grad():
        got = tp([torch.from_numpy(e0), torch.from_numpy(e1)], kernels=kernels)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("hw,out", [((6, 10), (12, 20)), ((7, 5), (3, 2)),
                                    ((9, 4), (9, 13))])
def test_resize_nearest_matches_jax(rng, hw, out):
    x = rng.standard_normal((1, *hw, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tinterp.resize_nearest(torch.from_numpy(x), out).numpy(),
        np.asarray(jinterp.resize_nearest(jnp.asarray(x), out)))


def test_bilinear_down_resize_matches_jax(rng):
    """fea_up0's down-resize (torch semantics, no antialias)."""
    x = rng.standard_normal((1, 102, 86, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tinterp.resize_bilinear(torch.from_numpy(x), (51, 43)).numpy(),
        np.asarray(jinterp.resize_bilinear(jnp.asarray(x), (51, 43))),
        atol=5e-6)


def test_srflow_weights_round_trip():
    jm, jp, tm, tp = tiny_pair()
    sd = tm.state_dict()
    assert set(sd) == set(srflow_state_dict(_np_tree(jm.params), tm.plan))
    back = convert_srflow(sd, jm.plan, nb=2, freeze=False)
    ref = _np_tree(jm.params)
    for k in ("conv_first", "trunk_conv", "upconv1", "upconv2", "hr_conv",
              "conv_last"):
        np.testing.assert_array_equal(np.asarray(back["rrdb"][k]["w"]),
                                      ref["rrdb"][k]["w"])
    np.testing.assert_array_equal(
        np.asarray(back["rrdb"]["trunk"][1]["rdb3"]["conv5"]["w"]),
        ref["rrdb"]["trunk"][1]["rdb3"]["conv5"]["w"])
    for e, b, r in zip(jm.plan, back["flow"]["layers"], ref["flow"]["layers"]):
        if e["kind"] in ("step_nc", "step_cond"):
            np.testing.assert_array_equal(np.asarray(b["invconv"]["w"]),
                                          r["invconv"]["w"])
            np.testing.assert_array_equal(np.asarray(b["actnorm"]["logs"]),
                                          r["actnorm"]["logs"])
        if e["kind"] == "step_cond":
            for t in ("fFeatures", "fAffine"):
                bt, rt = b["affine"][t], r["affine"][t]
                np.testing.assert_array_equal(np.asarray(bt["conv2"]["w"]),
                                              rt["conv2"]["w"])
                for k in ("w", "b", "logs"):
                    np.testing.assert_array_equal(np.asarray(bt["out"][k]),
                                                  rt["out"][k])
        if e["kind"] == "split":
            np.testing.assert_array_equal(np.asarray(b["conv"]["logs"]),
                                          r["conv"]["logs"])
    # the prior
    psd = tp.state_dict()
    assert set(psd) == set(srflow_unet_state_dict(_np_tree(jp.params)))
    pb = convert_srflow_unet(psd, depth=2)
    pr = _np_tree(jp.params)
    for b in ("branch0", "branch1"):
        np.testing.assert_array_equal(
            np.asarray(pb[b]["input_proj"]["conv5"]["w"]),
            pr[b]["input_proj"]["conv5"]["w"])
        np.testing.assert_array_equal(np.asarray(pb[b]["up"][1]["bn2"]["var"]),
                                      pr[b]["up"][1]["bn2"]["var"])
        np.testing.assert_array_equal(np.asarray(pb[b]["outc"]["w"]),
                                      pr[b]["outc"]["w"])


def test_plan_matches_jax():
    for args in ((4, 3, 16, 2, True), (4, 3, 2, 2, True), (4, 2, 3, 1, False)):
        assert build_plan(*args) == fup.build_plan(*args)
