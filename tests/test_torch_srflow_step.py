"""Port parity: the K5 twin (one fused conditional flow step) and the flow
primitives of ``bfsr_tpu_torch.ops.flows`` against the JAX package.

Tolerances: 2e-4 (abs and rel) for a step, as
``tests/test_flow_step_kernel.py`` holds the Pallas kernel; 5e-4 for the
reverse of the forward back to x; 5e-5 for the conditioning records and
the primitives (``docs/PARITY.md``'s module level); exact for the
squeezes, which only move values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.models.srflow import flow_upsampler as fup
from bfsr_tpu.ops import flows as jflows
from bfsr_tpu.ops.pallas import flow_step as fsk
from bfsr_tpu_torch.convert.from_jax import flow_step_state_dict
from bfsr_tpu_torch.models.srflow.flow_upsampler import FlowStep
from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops.cuda import flow_step as k5

from test_flow_step_kernel import _mk_step


def _np(t):
    return np.array(t)


def port_step(p, c, c_cond=320, hidden=64):
    """A frozen port FlowStep carrying the JAX step params ``p``."""
    step = FlowStep(c, c_cond, hidden)
    step.load_state_dict(flow_step_state_dict(
        jax.tree_util.tree_map(np.asarray, p)))
    step.freeze()
    return step


def record(cache):
    """A JAX ``cond_affine_cache`` as the port's per-pixel record."""
    return torch.from_numpy(np.concatenate(
        [_np(cache["scale_ft"]), _np(cache["shift_ft"]),
         _np(cache["aff1_ft"])], -1))


def _case(c, h, w, seed=0):
    key = jax.random.PRNGKey(seed)
    p = _mk_step(key, c)
    ft = jax.random.normal(jax.random.fold_in(key, 1), (1, h, w, 320)) * 0.3
    x = jax.random.normal(jax.random.fold_in(key, 2), (1, h, w, c))
    return p, ft, x, jflows.cond_affine_cache(ft, p["affine"])


@pytest.mark.parametrize("c,h,w", [(24, 20, 28), (96, 12, 12), (24, 17, 13),
                                   (12, 18, 14)])
def test_k5_twin_matches_jax_step(c, h, w):
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
    # the unfused module path (kernels=False) is the same step
    np.testing.assert_allclose(step.forward_step(xt, rec, kernels=False)
                               .detach().numpy(), _np(ref_f), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(
        step.reverse_step(torch.from_numpy(_np(ref_f)), rec, kernels=False)
        .detach().numpy(), _np(ref_r), atol=2e-4, rtol=2e-4)


def test_k5_twin_matches_pallas_kernel_interpret():
    c, h, w = 24, 9, 11
    p, ft, x, cache = _case(c, h, w, seed=5)
    prep = fsk.prep_step(p, c, phases=1)
    cp = fsk.pack_cache(cache, h, w)
    zf = fsk.step_apply(fsk.pad_state(x), cp, prep, h, w, interpret=True)
    zr = fsk.step_apply(zf, cp, prep, h, w, reverse=True, interpret=True)
    ref_f = fsk.unpad_state(zf, h, w, c)
    ref_r = fsk.unpad_state(zr, h, w, c)
    step = port_step(p, c)
    rec = record(cache)
    got_f = k5.flow_step_forward(torch.from_numpy(_np(x)), rec, step.kpacked,
                                 64)
    np.testing.assert_allclose(got_f.numpy(), _np(ref_f), atol=2e-4,
                               rtol=2e-4)
    got_r = k5.flow_step_reverse(got_f, rec, step.kpacked, 64)
    np.testing.assert_allclose(got_r.numpy(), _np(ref_r), atol=2e-4,
                               rtol=2e-4)


def test_packed_step_layout():
    c, hid = 24, 64
    p, _, _, _ = _case(c, 4, 4, seed=2)
    step = port_step(p, c)
    parts = k5.unpack_step(step.kpacked, c, hid)
    aff = jax.tree_util.tree_map(np.asarray, p["affine"]["fAffine"])
    gain = np.exp(aff["out"]["logs"] * 3.0)
    w3 = aff["out"]["w"] * gain                      # (3, 3, hid, 2co) HWIO
    co = c // 2
    np.testing.assert_allclose(parts["w3"][:, :, :co].numpy(),
                               w3[..., 1::2].reshape(9, hid, co), rtol=1e-6)
    np.testing.assert_allclose(parts["w3"][:, :, co:].numpy(),
                               w3[..., 0::2].reshape(9, hid, co), rtol=1e-6)
    np.testing.assert_allclose(parts["w1"].numpy(), aff["conv1"]["w"][
        :, :, :c // 2].reshape(9, c // 2, hid), rtol=1e-6)
    np.testing.assert_allclose(parts["w2"].numpy(), aff["conv2"]["w"][0, 0],
                               rtol=1e-6)
    with pytest.raises(ValueError):
        k5.unpack_step(step.kpacked, c, 32)


def test_conditioning_records_match_jax():
    """cond_affine_cache_batched over K steps against JAX's batched cache
    (5e-5)."""
    key = jax.random.PRNGKey(4)
    c, h, w = 12, 10, 7
    ps = [_mk_step(jax.random.fold_in(key, i), c, c_cond=40, hidden=16)
          for i in range(3)]
    ft = jax.random.normal(jax.random.fold_in(key, 9), (1, h, w, 40))
    ref = jflows.cond_affine_cache_batched(ft, [p["affine"] for p in ps])
    steps = [port_step(p, c, c_cond=40, hidden=16) for p in ps]
    got = flows.cond_affine_cache_batched(torch.from_numpy(_np(ft)),
                                          [s.affine for s in steps])
    for g, r in zip(got, ref):
        assert g.shape == (1, h, w, 2 * c + 16) and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), record(r).numpy(), atol=5e-5,
                                   rtol=5e-5)


def test_squeeze_unsqueeze_exact(rng):
    x = rng.standard_normal((1, 6, 10, 3)).astype(np.float32)
    sq = flows.squeeze2d(torch.from_numpy(x))
    np.testing.assert_array_equal(sq.numpy(),
                                  _np(jflows.squeeze2d(jnp.asarray(x))))
    np.testing.assert_array_equal(flows.unsqueeze2d(sq).numpy(), x)
    y = rng.standard_normal((1, 3, 5, 24)).astype(np.float32)
    np.testing.assert_array_equal(flows.unsqueeze2d(torch.from_numpy(y))
                                  .numpy(),
                                  _np(jflows.unsqueeze2d(jnp.asarray(y))))


def test_fold_and_an_invconv_match_jax(rng):
    c = 24
    p = _mk_step(jax.random.PRNGKey(6), c)
    step = port_step(p, c)
    for k in ("w_fold", "b_fold", "w_inv_fold", "an_bias"):
        np.testing.assert_allclose(step.fold[k].numpy(), _np(p["anic"][k]),
                                   atol=5e-6, rtol=5e-6)
    x = rng.standard_normal((1, 5, 6, c)).astype(np.float32)
    for reverse in (False, True):
        ref, _ = jflows.an_invconv_fused(jnp.asarray(x), p["anic"], None,
                                         reverse=reverse)
        got = flows.an_invconv_fused(torch.from_numpy(x), step.fold, reverse)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("c", [12, 24])
def test_split2d_matches_jax(rng, c):
    key = jax.random.PRNGKey(c)
    jp = jflows.init_split2d(key, c)
    jp["conv"] = {k: jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
                  for k, v in jp["conv"].items()}
    split = flows.Split2d(c)
    cp = jax.tree_util.tree_map(np.asarray, jp["conv"])
    split.conv.load_state_dict({
        "weight": torch.from_numpy(cp["w"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(cp["b"]),
        "logs": torch.from_numpy(cp["logs"]).reshape(-1, 1, 1)})
    x = rng.standard_normal((1, 6, 5, c)).astype(np.float32)
    z1, _, eps = jflows.split2d(jnp.asarray(x), jp, None)
    with torch.no_grad():
        gz1, geps = flows.split2d(torch.from_numpy(x), split)
        np.testing.assert_allclose(gz1.numpy(), _np(z1), atol=5e-5)
        np.testing.assert_allclose(geps.numpy(), _np(eps), atol=5e-5,
                                   rtol=5e-5)
        e = rng.standard_normal(geps.shape).astype(np.float32)
        ref, _, _ = jflows.split2d(z1, jp, None, reverse=True,
                                   eps=jnp.asarray(e))
        got = flows.split2d(gz1, split, reverse=True, eps=torch.from_numpy(e))
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5,
                                   rtol=5e-5)
        back = flows.split2d(gz1, split, reverse=True, eps=geps)
        np.testing.assert_allclose(back.numpy(), x, atol=5e-5, rtol=5e-5)


def test_flow_f_matches_jax(rng):
    """The unsplit coupling tower (the fFeatures branch) against JAX."""
    c = 12
    p = _mk_step(jax.random.PRNGKey(8), c, c_cond=20, hidden=16)
    step = port_step(p, c, c_cond=20, hidden=16)
    ft = rng.standard_normal((1, 5, 7, 20)).astype(np.float32)
    ref = jflows.flow_f(jnp.asarray(ft), p["affine"]["fFeatures"])
    with torch.no_grad():
        got = flows.flow_f(torch.from_numpy(ft), step.affine.fFeatures)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5, rtol=5e-5)
