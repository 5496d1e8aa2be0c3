"""Port parity for SRFlow beyond the 4x L 3 flow: the 8x model (scale 8,
L 4: levels on fea_up4 / fea_up2 / fea_up1 / fea_up0, splits at levels 1
and 2, K5 at C = 12, 24, 48 and 192), the 4x L 4 flow on ``fea_up-1``
(``fea_upm1``) and the 4x flow with unstacked conditioning, each against
the JAX model on the same weights (through ``convert/from_jax.py``), at
the tiny config of ``tests/test_torch_srflow_nll.py`` (RRDB nf 8, nb 2, gc
4; K 2, hidden 8, stack (0, 1)), with the flow live.

Tolerances (``docs/PARITY.md``'s module level): 5e-5 absolute and 2e-5
relative for the RRDB maps, the conditioning, the epses, the decode and
the heat-0 sample; 2e-4 for one K5 step (as ``tests/test_torch_srflow_
step.py``), 5e-4 for its reverse back to x; K5's one-pass twins as
``tests/test_torch_srflow_default.py`` holds them (the ``pallas`` form
against the JAX kernel in interpret mode within 2e-2 max and 1e-4 mean, a
tie flip; the ``xla`` form against the unfused step within 1e-4); the
sampler's clipped image within 5e-4, as ``tests/test_torch_srflow_base_
train.py`` holds it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.convert.torch_import import convert_srflow
from bfsr_tpu.models.rrdb import rrdb_apply_steps
from bfsr_tpu.models.srflow import flow_upsampler as fup
from bfsr_tpu.models.srflow.srflow_net import rrdb_preprocess as j_preprocess
from bfsr_tpu.pipelines.srflow_eval import SRFlowLPPredictor as JPredictor
from bfsr_tpu.pipelines.srflow_eval import sample_sr as j_sample_sr
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import srflow_state_dict
from bfsr_tpu_torch.entry import build_srflow_x8, srflow_specs, srflow_x8_spec
from bfsr_tpu_torch.models.srflow.flow_upsampler import build_plan
from bfsr_tpu_torch.models.srflow.srflow_net import rrdb_preprocess
from bfsr_tpu_torch.ops.cuda import flow_step as k5
from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                  lr_multiple, sample_sr)
from bfsr_tpu_torch.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step)

from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_srflow_default import (_pallas_form_against_kernel,
                                       _set_both, _xla_twin_against_unfused)
from test_torch_srflow_models import _np_tree, live_flow
from test_torch_srflow_step import _case, _np, port_step, record

TOL = {"rtol": 2e-5, "atol": 5e-5}
TINY = srflow_specs(tiny=True)[0]["args"]
# the flows beside the flagship's: (name, args over the tiny config, LR hw)
CONFIGS = {"x8": ({"scale": 8, "L": 4}, (4, 6)),
           "x4_L4_upm1": ({"scale": 4, "L": 4, "fea_upm1": True}, (4, 8)),
           "x4_unstacked": ({"scale": 4, "L": 3, "stack_concat": False},
                            (4, 6))}


def _spec(args):
    return {"name": "srflow", "args": {**TINY, **args}}


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX SRFlowNet with a live flow, frozen; the port's on its weights,
    frozen) of ``CONFIGS[name]``.  Built once per process; callers must not
    change them."""
    spec = _spec(CONFIGS[name][0])
    jm = jregistry.make(spec)
    jm.params = live_flow(jm.params)
    jm.freeze()
    tm = registry.make(spec)
    tm.load_state_dict(srflow_state_dict(_np_tree(jm.params), tm.plan))
    return jm, tm.eval().freeze()


def _inputs(name, seed=0):
    """(LR (1, h, w, 3), GT (1, s h, s w, 3)) in [0, 1] from a seed."""
    args, (h, w) = CONFIGS[name]
    s = args["scale"]
    rng = np.random.default_rng(seed)
    return (rng.random((1, h, w, 3)).astype(np.float32),
            rng.random((1, s * h, s * w, 3)).astype(np.float32))


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               err_msg=err_msg, **TOL)


@pytest.mark.parametrize("scale,L", [(8, 4), (4, 4), (4, 3)])
def test_plan_matches_jax(scale, L):
    """The static plan: at (8, 4) splits at levels 1 and 2 and a final
    latent of 192 channels (16 conditional steps a level at K 16)."""
    got, got_c = build_plan(scale, L, 16, 2, True)
    ref, ref_c = fup.build_plan(scale, L, 16, 2, True)
    assert got == ref and got_c == ref_c
    if L == 4:
        assert got_c == 192
        assert [e["c"] for e in got if e["kind"] == "split"] == [12, 24]
        conds = [e["c"] for e in got if e["kind"] == "step_cond"]
        assert conds == [12] * 16 + [24] * 16 + [48] * 16 + [192] * 16


@pytest.mark.parametrize("name", ["x8", "x4_L4_upm1"])
@pytest.mark.parametrize("kernels", [True, False])
def test_rrdb_steps_match_jax(name, kernels):
    """``RRDBNet.steps`` computes the maps the flow reads (x8: ``fea_up4``
    from upconv2; x4 L 4: ``fea_up-1``) and no other."""
    jm, tm = pair(name)
    lr, _ = _inputs(name)
    keys = tuple(tm.cond_keys())
    want = {"x8": ("fea_up4", "fea_up2", "fea_up1", "fea_up0"),
            "x4_L4_upm1": ("fea_up2", "fea_up1", "fea_up0", "fea_up-1")}
    assert keys == want[name]
    args = CONFIGS[name][0]
    ref = rrdb_apply_steps(jm.params["rrdb"], jnp.asarray(lr),
                           scale=args["scale"], block_idxs=(0, 1),
                           fea_up0=True, fea_upm1=args.get("fea_upm1", False))
    with torch.no_grad():
        got = tm.RRDB.steps(torch.from_numpy(lr), keys, (0, 1), kernels)
    assert set(got) == {"block_0", "block_1", *keys}
    for k, v in got.items():
        _close(v, ref[k], err_msg=k)


@pytest.mark.parametrize("concat", [True, False])
def test_rrdb_preprocess_matches_jax(concat):
    """The x8 conditioning with and without the stacked blocks: 24 or 8
    channels at each of the four maps."""
    jm, tm = pair("x8")
    lr, _ = _inputs("x8", 1)
    ref = j_preprocess(jm.params["rrdb"], jnp.asarray(lr), 8, (0, 1),
                       concat=concat, fea_up0=True)
    keys = tm.cond_keys()
    with torch.no_grad():
        got = rrdb_preprocess(tm.RRDB, torch.from_numpy(lr), (0, 1), keys,
                              concat=concat)
    for k in keys:
        assert got[k].shape[-1] == (24 if concat else 8)
        _close(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("c,h,w", [(48, 10, 12), (192, 6, 5), (48, 7, 9),
                                   (192, 4, 4)])
def test_k5_twin_at_x8_widths_matches_jax_step(c, h, w):
    """``tests/test_torch_srflow_step.py::test_k5_twin_matches_jax_step``
    at the widths of the 8x model's levels 3 and 4."""
    p, ft, x, cache = _case(c, h, w)
    ref_f, _ = fup._step_forward(x, p, ft, None, cond=True, ft_params=cache)
    ref_r, _ = fup._step_reverse(ref_f, p, ft, None, cond=True,
                                 ft_params=cache)
    step = port_step(p, c)
    rec, xt = record(cache), torch.from_numpy(_np(x))
    got_f = k5.flow_step_forward(xt, rec, step.kpacked, 64)
    np.testing.assert_allclose(got_f.numpy(), _np(ref_f), atol=2e-4,
                               rtol=2e-4)
    got_r = k5.flow_step_reverse(torch.from_numpy(_np(ref_f)), rec,
                                 step.kpacked, 64)
    np.testing.assert_allclose(got_r.numpy(), _np(ref_r), atol=2e-4,
                               rtol=2e-4)
    back = k5.flow_step_reverse(got_f, rec, step.kpacked, 64)
    np.testing.assert_allclose(back.numpy(), _np(x), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("c,h,w", [(48, 5, 6), (192, 4, 3)])
def test_k5_one_pass_twins_at_x8_widths(restore_modes, c, h, w):
    """Both one-pass forms' twins at C = 48 and 192: the ``pallas`` form
    against the JAX FlowStep kernel at passes=1 in interpret mode, the
    ``xla`` form against the unfused step under ``default``."""
    p, _, x, cache = _case(c, h, w, seed=c)
    _set_both("default")
    for got, ref in _pallas_form_against_kernel(p, x, cache, c, h, w):
        err = np.abs(got - ref)
        assert err.max() <= 2e-2, err.max()
        assert err.mean() <= 1e-4, err.mean()
    step = port_step(p, c)
    with torch.no_grad():
        _xla_twin_against_unfused(step, torch.from_numpy(_np(x)),
                                  record(cache), c)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kernels", [True, False])
def test_encode_and_decode_match_jax(name, kernels):
    """The encode's epses (no noise; x8: three, at 6, 12 and 192
    channels), the decode of the JAX epses, and the round trip."""
    jm, tm = pair(name)
    lr, gt = _inputs(name, 2)
    ref, _, _ = jm.normal_flow(jm.params, jnp.asarray(gt), jnp.asarray(lr),
                               add_gt_noise=False, want_logdet=False)
    ref_sr, _ = jm.reverse_flow(jm.params, jnp.asarray(lr), epses=ref,
                                want_logdet=False)
    with torch.no_grad():
        cache = tm.precompute_ft(tm.rrdb_preprocess(torch.from_numpy(lr)))
        got = tm.normal_flow(torch.from_numpy(gt), cache, kernels)
        assert len(got) == len(ref) == 1 + sum(
            e["kind"] == "split" for e in tm.plan)
        for g, r in zip(got, ref):
            _close(g, r)
        sr = tm.reverse_flow([torch.from_numpy(_np(e)) for e in ref], cache,
                             kernels)
        _close(sr, ref_sr)
        _close(tm.reverse_flow(got, cache, kernels), gt)
    if name == "x8":
        assert [tuple(e.shape) for e in got] == [
            (1, 16, 24, 6), (1, 8, 12, 12), (1, 2, 3, 192)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_get_sr_at_heat_0_matches_jax(name):
    """``get_sr`` from a zero final latent and zero split epses."""
    jm, tm = pair(name)
    lr, _ = _inputs(name, 3)
    ref = jm.get_sr(jm.params, jnp.asarray(lr), heat=0.0)
    with torch.no_grad():
        got = tm.get_sr(torch.from_numpy(lr), heat=0.0)
    _close(got, ref)
    z = tm.sample_z(0.0, lr.shape[1:3])
    assert tuple(z.shape) == tuple(jm.sample_z(None, 0.0, 1,
                                               lr.shape[1:3]).shape)


def test_sample_sr_at_x8_matches_jax():
    """The sampler at x8: padded to even, 8h x 8w out, the JAX sampler's
    image at heat 0; a nonzero heat, on the port's own random flow (whose
    couplings sit near the identity: the JAX weights' decode overflows at
    heat 0.7 at this depth), finite, the same under a seed and not under
    another."""
    jm, tm = pair("x8")
    lr = np.random.default_rng(4).random((5, 6, 3)).astype(np.float32)
    assert lr_multiple(tm) == 2
    ref = j_sample_sr(jm, lr, heat=0.0)
    got = sample_sr(tm, lr, heat=0.0)
    assert got.shape == ref.shape == (40, 48, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)
    tm = build_srflow_x8("cpu", tiny=True)
    hot = [sample_sr(tm, lr, heat=0.7, seed=s) for s in (3, 3, 4)]
    assert torch.equal(hot[0], hot[1]) and not torch.equal(hot[0], hot[2])
    assert all(torch.isfinite(h).all() for h in hot)


def test_weights_round_trip_with_upconv3():
    """The x8 RRDB carries ``upconv3`` both ways: from_jax names it as the
    reference does, and the JAX converter reads the port's state_dict
    back to the JAX params."""
    jm, tm = pair("x8")
    sd = tm.state_dict()
    assert {"RRDB.upconv3.weight", "RRDB.upconv3.bias"} <= set(sd)
    assert set(sd) == set(srflow_state_dict(_np_tree(jm.params), tm.plan))
    back = convert_srflow(sd, jm.plan, nb=2, scale=8, freeze=False)
    ref = _np_tree(jm.params)
    for k in ("upconv1", "upconv2", "upconv3", "hr_conv", "conv_last"):
        np.testing.assert_array_equal(np.asarray(back["rrdb"][k]["w"]),
                                      ref["rrdb"][k]["w"])
    for e, b, r in zip(jm.plan, back["flow"]["layers"], ref["flow"]["layers"]):
        if e["kind"] == "step_cond":
            np.testing.assert_array_equal(
                np.asarray(b["affine"]["fAffine"]["out"]["w"]),
                r["affine"]["fAffine"]["out"]["w"])
    # and the x8 head's forward, the image at 8x
    lr, _ = _inputs("x8")
    with torch.no_grad():
        img = tm.RRDB(torch.from_numpy(lr), kernels=False)
    assert tuple(img.shape) == (1, 32, 48, 3)


def test_prior_paths_refuse_an_l4_flow():
    """SRFlow-LP's two-branch prior reads an L 3 flow's [eps0, z]: the
    predictor and the prior trainer refuse the x8 flow with a clear error,
    where the JAX predictor fails on the same input with a reshape
    ``TypeError`` (its prior reads the 12-channel split latent as z)."""
    jm, tm = pair("x8")
    pspec = srflow_specs(tiny=True)[1]
    prior = registry.make(pspec).eval()
    with pytest.raises(ValueError, match="L 3"):
        SRFlowLPPredictor(tm, prior)
    opt = torch.optim.Adam(prior.parameters())
    with pytest.raises(ValueError, match="L 3"):
        make_srflow_prior_train_step(tm, prior.train(), opt)
    jprior = jregistry.make(pspec)
    lr = np.random.default_rng(5).random((6, 8, 3)).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        JPredictor(jm, jprior).predict(lr)


def test_configs_the_port_does_not_run_raise():
    """A level whose map is switched off (``fea_up0: false`` at L 3,
    ``fea_upm1`` off at 4x L 4) raises a ``ValueError`` where the JAX
    model meets a ``KeyError``; so do a level no scale has (16x stops at
    L 4, as ``LEVEL_NAMES[16]`` does) and a scale with no maps."""
    with pytest.raises(ValueError, match="levels"):
        registry.make(_spec({"scale": 16, "L": 5}))
    with pytest.raises(ValueError, match="scale"):
        registry.make(_spec({"scale": 32, "L": 4}))
    with pytest.raises(ValueError, match="fea_up0"):
        registry.make(_spec({"fea_up0": False}))
    with pytest.raises(ValueError, match="fea_upm1"):
        registry.make(_spec({"L": 4}))
    with pytest.raises(ValueError, match="levels"):
        registry.make(_spec({"scale": 8, "L": 5}))
    jm = jregistry.make(_spec({"fea_up0": False}))
    lr = jnp.zeros((1, 4, 6, 3))
    with pytest.raises(KeyError, match="fea_up0"):
        jm.get_sr(jm.params, lr, heat=0.0)
    assert registry.make(srflow_x8_spec(tiny=True)).final_c == 192
