"""Port parity for SRFlow's NLL path: the flow primitives with their
log-dets, the log-det encode and decode, ``normal_flow_nll`` /
``reverse_flow_logdet`` and ``sample_z`` against ``bfsr_tpu/ops/flows.py``
and ``bfsr_tpu/models/srflow``, at the tiny config of
``tests/test_srflow_train_and_measure.py`` (RRDB nf 8, nb 2, gc 4; K 2, L
3, hidden 8, stack (0, 1); B 2 of 16^2 GT), the flow live and unfrozen
(no cached inverse: both sides solve at run time, as a trainer does).

Tolerances: each primitive's output and log-det within 2e-5 relative and
5e-5 absolute (``docs/PARITY.md``'s module level); the NLL within 1e-5
relative; the encode -> decode round trip within 5e-5 of x, its two
log-dets cancelling within 1e-5 of their size.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.models.srflow import flow_upsampler as fup
from bfsr_tpu.ops import flows as jflows
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import srflow_state_dict
from bfsr_tpu_torch.entry import srflow_specs, synthetic_lrhr_sample
from bfsr_tpu_torch.models.base import seeded
from bfsr_tpu_torch.ops import flows

from test_torch_srflow_models import _np_tree, live_flow
from test_torch_srflow_step import record

TOL = {"rtol": 2e-5, "atol": 5e-5}
QUANT = 32


@functools.lru_cache(maxsize=1)
def _jax_model():
    fs, _ = srflow_specs(tiny=True)
    jm = jregistry.make(fs)
    jm.params = live_flow(jm.params)
    return jm


def base_pair():
    """(JAX SRFlowNet with live, unfrozen params; a fresh port SRFlowNet
    with the same weights, frozen)."""
    jm = _jax_model()
    fs, _ = srflow_specs(tiny=True)
    tm = registry.make(fs)
    tm.load_state_dict(srflow_state_dict(_np_tree(jm.params), tm.plan))
    return jm, tm.freeze()


def batch(seed=0, n=2, gt_size=16):
    rng = np.random.default_rng(seed)
    samples = [synthetic_lrhr_sample(rng, gt_size) for _ in range(n)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def jax_noise(key, shape):
    """The quantisation noise the JAX ``normal_flow`` draws from ``key``."""
    return np.array((jax.random.uniform(key, shape, jnp.float32) - 0.5)
                    / QUANT)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               **(tol or TOL))


def _cond_step(level=2):
    """The first conditional step of ``level``: (plan index, JAX params,
    port FlowStep)."""
    jm, tm = base_pair()
    i = next(i for i, e in enumerate(jm.plan)
             if e["kind"] == "step_cond" and e["level"] == level)
    return i, jm.params["flow"]["layers"][i], tm.flowUpsamplerNet.layers[i]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prim", ["actnorm", "invconv", "cond_affine",
                                  "split2d"])
def test_logdet_primitive_matches_jax(rng, prim, reverse):
    i, p, step = _cond_step()
    c = step.actnorm.bias.shape[1]
    x = rng.standard_normal((2, 5, 6, c)).astype(np.float32)
    ld = rng.standard_normal(2).astype(np.float32)
    jx, tx, jld, tld = (jnp.asarray(x), torch.from_numpy(x), jnp.asarray(ld),
                        torch.from_numpy(ld))
    if prim == "actnorm":
        ref = jflows.actnorm(jx, p["actnorm"], jld, reverse)
        got = flows.actnorm_logdet(tx, step.actnorm, tld, reverse)
    elif prim == "invconv":
        ref = jflows.invconv1x1(jx, p["invconv"], jld, reverse)
        got = flows.invconv1x1(tx, step.invconv, tld, reverse)
    elif prim == "cond_affine":
        ft = jnp.asarray(rng.standard_normal((2, 5, 6, 24)), jnp.float32)
        cache = jflows.cond_affine_cache(ft, p["affine"])
        ref = jflows.cond_affine(jx, ft, p["affine"], jld, reverse,
                                 ft_params=cache)
        got = flows.cond_affine_logdet(tx, record(cache), step.affine, tld,
                                       reverse)
    else:
        jm, tm = base_pair()
        k = next(k for k, e in enumerate(jm.plan) if e["kind"] == "split")
        sp, split = jm.params["flow"]["layers"][k], tm.flowUpsamplerNet.layers[k]
        x12 = rng.standard_normal((2, 5, 6, 12)).astype(np.float32)
        if not reverse:
            ref = jflows.split2d(jnp.asarray(x12), sp, jld)
            got = flows.split2d_logdet(torch.from_numpy(x12), split, tld)
            _close(got[2], ref[2])
        else:
            eps = rng.standard_normal((2, 5, 6, 6)).astype(np.float32)
            ref = jflows.split2d(jnp.asarray(x12[..., :6]), sp, jld,
                                 reverse=True, eps=jnp.asarray(eps))
            got = flows.split2d_logdet(torch.from_numpy(x12[..., :6]), split,
                                       tld, reverse=True,
                                       eps=torch.from_numpy(eps))
    with torch.no_grad():
        _close(got[0], ref[0])
        _close(got[1], ref[1])


def test_gaussian_logp_matches_jax(rng):
    x, mean, logs = (rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
                     for _ in range(3))
    for args in ((x,), (x, mean, logs)):
        ref = jflows.gaussian_logp(*map(jnp.asarray, args))
        got = flows.gaussian_logp(*map(torch.from_numpy, args))
        _close(got, ref)


def test_split2d_samples_from_a_generator():
    """Reverse split without eps: zeros with no generator at heat 0 (and
    refused at heat > 0), N(0, eps_std^2) draws from a generator, the same
    under the same seed."""
    _, tm = base_pair()
    k = next(k for k, e in enumerate(tm.plan) if e["kind"] == "split")
    split = tm.flowUpsamplerNet.layers[k]
    z1 = torch.randn((2, 4, 4, 6), generator=seeded(1))
    with torch.no_grad():
        zero, _, _ = flows.split2d_logdet(z1, split, None, reverse=True)
        ref = flows.split2d(z1, split, reverse=True,
                            eps=torch.zeros(2, 4, 4, 6))
        assert torch.equal(zero, ref)
        with pytest.raises(ValueError, match="generator"):
            flows.split2d_logdet(z1, split, None, reverse=True, eps_std=0.5)
        a, b = (flows.split2d_logdet(z1, split, None, reverse=True,
                                     eps_std=0.5, generator=seeded(3))[0]
                for _ in range(2))
        assert torch.equal(a, b) and not torch.equal(a, zero)


@pytest.fixture(scope="module")
def jax_nll():
    """The JAX encode with a log-det (the noise passed in) and the decode of
    its epses with one, on batch 0."""
    jm, _ = base_pair()
    data = batch()
    noise = jax_noise(jax.random.PRNGKey(3), data["GT"].shape)
    lq = jnp.asarray(data["LQ"])
    epses, nll, logdet = jm.normal_flow(
        jm.params, jnp.asarray(data["GT"] + noise), lq, add_gt_noise=False)
    sr, rlogdet = jm.reverse_flow(jm.params, lq, epses=epses,
                                  add_gt_noise=True)
    return data, noise, _np_tree((epses, nll, logdet, sr, rlogdet))


def _port_cache(tm, lq):
    with torch.no_grad():
        return tm.precompute_ft(tm.rrdb_preprocess(torch.from_numpy(lq)))


def test_normal_flow_nll_matches_jax(jax_nll):
    """The port's NLL with the noise passed in against JAX's
    ``normal_flow(add_gt_noise=False)`` of GT plus that noise, whose log-det
    lacks the ``-log(quant) * pixels`` term: log2(quant) bits/dim apart."""
    data, noise, (epses, nll, logdet, _, _) = jax_nll
    _, tm = base_pair()
    pixels = data["GT"].shape[1] * data["GT"].shape[2]
    with torch.no_grad():
        got_e, got_nll, got_ld = tm.normal_flow_nll(
            torch.from_numpy(data["GT"]), _port_cache(tm, data["LQ"]),
            noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got_nll.numpy(), nll + math.log2(QUANT),
                               rtol=1e-5)
    np.testing.assert_allclose(got_ld.numpy(),
                               logdet - math.log(QUANT) * pixels, rtol=1e-5)
    for g, r in zip(got_e, epses):
        _close(g, r)


def test_reverse_flow_logdet_matches_jax(jax_nll):
    data, _, (epses, _, logdet, sr, rlogdet) = jax_nll
    _, tm = base_pair()
    with torch.no_grad():
        got, got_ld = tm.reverse_flow_logdet(
            [torch.from_numpy(e) for e in epses], _port_cache(tm, data["LQ"]))
    _close(got, sr)
    np.testing.assert_allclose(got_ld.numpy(), rlogdet, rtol=1e-5)
    # the decode's log-det undoes the encode's (the noise term both ways)
    pixels = data["GT"].shape[1] * data["GT"].shape[2]
    np.testing.assert_allclose(got_ld.numpy(),
                               -(logdet - math.log(QUANT) * pixels),
                               rtol=1e-5)


def test_encode_decode_round_trip_and_logdets_cancel():
    _, tm = base_pair()
    data = batch(1)
    gt = torch.from_numpy(data["GT"])
    fun = tm.flowUpsamplerNet
    with torch.no_grad():
        cache = _port_cache(tm, data["LQ"])
        epses, ld = fun.encode_logdet(gt, cache, torch.zeros(2))
        back, ld_back = fun.decode_logdet(epses, cache, torch.zeros(2))
    np.testing.assert_allclose(back.numpy(), data["GT"], atol=5e-5)
    assert float((ld + ld_back).abs().max()) <= 1e-5 * float(ld.abs().max())
    # the kernel path's decode (K5's twin here) from the same epses
    with torch.no_grad():
        np.testing.assert_allclose(tm.reverse_flow(epses, cache).numpy(),
                                   data["GT"], atol=5e-4)


def test_log_det_encode_is_differentiable_in_the_weights():
    """Autograd reaches every flow weight the NLL reads, through the
    records too (``precompute_ft(differentiable=True)``)."""
    _, tm = base_pair()
    data = batch(2)
    with torch.no_grad():
        lr_enc = tm.rrdb_preprocess(torch.from_numpy(data["LQ"]))
    cache = tm.precompute_ft(lr_enc, differentiable=True)
    _, nll, _ = tm.normal_flow_nll(torch.from_numpy(data["GT"]), cache,
                                   generator=seeded(0))
    nll.mean().backward()
    flow = dict(tm.flowUpsamplerNet.named_parameters())
    dead = [k for k, v in flow.items()
            if v.grad is None or not v.grad.abs().sum() > 0]
    assert not dead, dead


def test_sample_z_takes_a_batch():
    jm, tm = base_pair()
    ref = jm.sample_z(jax.random.PRNGKey(0), 0.7, 3, (6, 10))
    z = tm.sample_z(0.7, (6, 10), 3, seeded(0))
    assert tuple(z.shape) == ref.shape == (3, 3, 5, tm.final_c)
    assert torch.equal(tm.sample_z(0.0, (6, 10), 3), torch.zeros(z.shape))
    assert torch.equal(z, tm.sample_z(0.7, (6, 10), 3, seeded(0)))
    assert 0.5 < float(z.std()) < 0.9


def test_get_sr_at_heat_0_matches_jax():
    """``get_sr`` at heat 0 (zero latent, zero split eps) against JAX's, on
    the kernel path (K5's and K3's twins on the CPU)."""
    jm, tm = base_pair()
    lq = batch(3)["LQ"]
    ref = np.asarray(jm.get_sr(jm.params, jnp.asarray(lq), heat=0.0))
    with torch.no_grad():
        got = tm.get_sr(torch.from_numpy(lq), heat=0.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=5e-4)
    assert not np.allclose(ref, ref.mean())
