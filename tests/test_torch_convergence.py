"""The port's trainers LEARN: the four convergence tests of
``tests/test_convergence.py`` on the port, on the CPU.

Each test starts from the JAX test's own initial weights (carried across
by ``convert/from_jax.py``), trains with the JAX test's tiny config,
optimizer, data and step count, and holds the JAX test's thresholds: the
loss falls by a large factor, and a held-out metric beats both the
initial weights and the no-learning baseline.  The held-out metrics are
the curve scripts' own (``bfsr_tpu_torch/profiling/*train_curve.py``).

Anchors to the JAX package, cheap (no JAX training):

* the task functions (``profiling/learnable_task.py``) equal the JAX
  test's helpers and the JAX curves' (1e-6), and the torch pair maker
  equals the numpy one on the same coarse field (1e-6);
* each test's held-out PSNR at the initial weights, and its no-prior
  PSNR, equal the JAX model's on the same weights and images within 1e-3
  dB (JAX forward passes);
* ``train.optim.clip_by_global_norm`` equals ``optax.clip_by_global_norm``
  on the same gradients, above the limit within 1e-6 relative (the norm's
  f32 sums in another order, the scale applied as one factor) and below
  it bit for bit.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.data.wrappers import resize_bilinear_np as j_resize
from bfsr_tpu.models.srflow.srflow_net import (
    standardize_epses as j_standardize)
from bfsr_tpu.ops.interp import resize_bilinear as j_resize_bilinear
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import (load_linf, load_srflow,
                                             load_srflow_unet, load_unet,
                                             load_vgg, rrdb_state_dict,
                                             srflow_state_dict)
from bfsr_tpu_torch.entry import flagship_specs, srflow_specs
from bfsr_tpu_torch.pipelines.linf_train import make_train_step, to_device
from bfsr_tpu_torch.pipelines.sr_train import make_sr_train_step
from bfsr_tpu_torch.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step)
from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step
from bfsr_tpu_torch.profiling import learnable_task as task
from bfsr_tpu_torch.profiling.prior_train_curve import decode_psnrs
from bfsr_tpu_torch.profiling.srflow_train_curve import heat0_psnr
from bfsr_tpu_torch.profiling.train_curve import heldout_psnrs
from bfsr_tpu_torch.train.optim import clip_by_global_norm

import test_convergence as jc
from test_pipelines import small_linf
from test_torch_srflow_models import _np_tree

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from profiling import prior_train_curve as j_prior_curve  # noqa: E402
from profiling import srflow_train_curve as j_srflow_curve  # noqa: E402
from profiling import train_curve as j_linf_curve  # noqa: E402

TASK_TOL = 1e-6
PSNR_TOL_DB = 1e-3
TINY_SRFLOW = {"name": "srflow", "args": {
    "nf": 8, "nb": 2, "gc": 4, "K": 2, "L": 3, "hidden_channels": 8,
    "stack_blocks": (0, 1)}}


@pytest.fixture
def one_thread():
    """torch on one thread: the tiny models' ops run ~2x faster than
    across every core of the machine (as under pytest-xdist, where
    ``torch_threads`` gives each worker its share)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adam(params, lr):
    """Adam as the curves run it on the card: the ``foreach`` form, torch's
    default for CUDA tensors (on CPU tensors the default is a loop over the
    parameters; the same update, ~15% slower for these tiny models)."""
    return torch.optim.Adam(params, lr=lr, foreach=True)


@pytest.fixture(scope="module")
def jax_srflow():
    """The JAX tests' tiny SRFlowNet at its initial weights, built once for
    the NLL and prior tests (neither changes it)."""
    return jregistry.make(TINY_SRFLOW)


def _train(step, batch_of, n):
    losses = [step(batch_of(i))["loss"] for i in range(n)]
    assert np.isfinite(losses).all()
    return np.mean(losses[:5]), np.mean(losses[-10:])


def _t(batch, keys=("GT", "LQ")):
    return to_device(batch, "cpu", keys)


# ---------------------------------------------------------------------------
# the anchors: the tasks and the clip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_fn,period", [
    (jc._checker, 2), (j_linf_curve._checker, 3),
    (j_srflow_curve._checker, 4), (j_prior_curve._checker, 4)])
def test_checker_matches_jax(jax_fn, period):
    """At each JAX helper's own period (its default)."""
    np.testing.assert_array_equal(task.checker(12, 10, period),
                                  jax_fn(12, 10))


@pytest.mark.parametrize("jax_fn,div,hw", [
    (jc._smooth_lr, 3, (8, 8)), (jc._smooth_lr, 3, (4, 4)),
    (j_linf_curve._smooth_lr, 3, (12, 12)),
    (j_srflow_curve._smooth_lr, 4, (10, 10)),
    (j_prior_curve._smooth_lr, 4, (9, 11))])
def test_smooth_lr_matches_jax(jax_fn, div, hw):
    got = task.smooth_lr(np.random.default_rng(4), 3, *hw, div)
    ref = jax_fn(np.random.default_rng(4), 3, *hw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TASK_TOL)


@pytest.mark.parametrize("jax_fn,period,h", [(jc._linf_batch, 2, 8),
                                             (j_linf_curve._batch, 3, 12)])
def test_linf_batch_matches_jax(jax_fn, period, h):
    scale = 2
    lr = task.smooth_lr(np.random.default_rng(1), 3, h, h)
    pattern = task.checker(h * scale, h * scale, period)
    got, got_norm = task.linf_batch(lr, pattern, scale)
    H = h * scale
    ref, ref_norm = jax_fn(lr, make_coord_np((H, H), flatten=False),
                           make_cell((H, H)), pattern)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0,
                                   atol=TASK_TOL, err_msg=k)
    np.testing.assert_allclose(got_norm, ref_norm, rtol=0, atol=TASK_TOL)


@pytest.mark.parametrize("lr_hw,amp,period,div", [
    ((4, 4), 0.1, 2, 3), ((8, 8), 0.18, 2, 3), ((10, 10), 0.08, 4, 4),
    ((10, 10), 0.12, 4, 4)])
def test_srflow_pair_matches_jax(lr_hw, amp, period, div):
    """The JAX tests' ``make_pair`` (nested in each test, so written out
    here as they write it) and the JAX curves' pair."""
    got = task.srflow_pair(np.random.default_rng(2), 3, lr_hw, 4, amp, period,
                           div)
    smooth = {3: jc._smooth_lr, 4: j_srflow_curve._smooth_lr}[div]
    check = {2: jc._checker, 4: j_srflow_curve._checker}[period]
    lq = smooth(np.random.default_rng(2), 3, *lr_hw)
    H, W = 4 * lr_hw[0], 4 * lr_hw[1]
    up = np.stack([j_resize(x, (H, W)) for x in lq])
    gt = np.clip(up + amp * check(H, W), 0.0, 1.0).astype(np.float32)
    np.testing.assert_allclose(got["LQ"], lq, rtol=0, atol=TASK_TOL)
    np.testing.assert_allclose(got["GT"], gt, rtol=0, atol=TASK_TOL)


def test_torch_pair_matches_numpy_pair():
    """``srflow_pair_t`` (the prior curve's pairs on the card) computes
    what the numpy builder computes from the same coarse field."""
    gen = torch.Generator().manual_seed(3)
    lr_hw, kw = (10, 10), {"scale": 4, "amp": 0.12, "period": 4}
    got = task.srflow_pair_t(gen, 3, lr_hw, div=4, **kw)
    coarse = torch.rand(task.coarse_shape(3, *lr_hw, 4),
                        generator=torch.Generator().manual_seed(3))
    ref = task.pair_from_lq(task.smooth_from_coarse(coarse.numpy(), *lr_hw),
                            **kw)
    for k in ("GT", "LQ"):
        assert got[k].shape == ref[k].shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0,
                                   atol=TASK_TOL, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Above the limit (0.5: every gradient scaled by max_norm / norm) and
    below it (1e3: unchanged, bit for bit)."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (3,), (4, 3, 3, 2), ()]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    seen = []
    opt = clip_by_global_norm(torch.optim.SGD(params, lr=0.0), max_norm)
    opt.register_step_pre_hook(
        lambda o, a, k: seen.extend(p.grad.clone() for p in params))
    opt.step()
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads))
    assert (norm > max_norm) == (max_norm == 0.5)
    for got, r, g in zip(seen, ref, grads):
        if norm < max_norm:
            np.testing.assert_array_equal(got.numpy(), g)
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)
    clipped = np.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in seen))
    assert clipped == pytest.approx(min(norm, max_norm), rel=1e-6)


# ---------------------------------------------------------------------------
# 1. LINF latent-module training (VGG + latent loss)
# ---------------------------------------------------------------------------

def test_linf_latent_training_learns(rng, one_thread):
    h, s = 8, 2
    H = h * s
    jm = small_linf()
    jprior = jregistry.make({"name": "unet", "args": {"in_chans": 3,
                                                      "depth": 2, "dim": 16}})
    jvgg = jregistry.make({"name": "VGGFeatureExtractor",
                           "args": {"feature_layer": 3}})
    linf_spec, prior_spec = flagship_specs(tiny=True)
    linf = load_linf(registry.make(linf_spec), _np_tree(jm.params))

    def port_prior():
        return load_unet(registry.make(prior_spec), _np_tree(jprior.params))

    vgg = load_vgg(registry.make({"name": "VGGFeatureExtractor",
                                  "args": {"feature_layer": 3}}),
                   _np_tree(jvgg.params)).requires_grad_(False)
    prior = port_prior().train()
    opt = _adam(prior.parameters(), 2e-3)
    step = make_train_step(linf, prior, vgg, opt, vgg_weight=1.0,
                           latent_weight=1.0)
    pattern = task.checker(H, H)
    batch = to_device(task.linf_batch(task.smooth_lr(rng, 4, h, h), pattern,
                                      s)[0], "cpu")
    init_loss, final_loss = _train(step, lambda i: batch, 300)
    assert final_loss < 0.25 * init_loss, (init_loss, final_loss)

    eval_lr = task.smooth_lr(np.random.default_rng(123), 2, h, h)
    psnr = heldout_psnrs(linf, {"no prior": None, "init": port_prior(),
                                "trained": prior.eval().freeze()},
                         eval_lr, pattern, s, 0.15)
    assert psnr["trained"] > psnr["no prior"] + 1.0, psnr
    assert psnr["trained"] > psnr["init"] + 1.0, psnr

    # the JAX model at the same weights, on the same held-out images
    ebatch, egt_norm = jc._linf_batch(eval_lr, make_coord_np(
        (H, H), flatten=False), make_cell((H, H)), pattern)

    @jax.jit
    def jax_preds(params, prior_params, b):
        inp = (b["inp"] - 0.5) / 0.5
        feat = jm.gen_feat(params, inp)
        _, z_lr = jm.query_log_p(params, inp, feat, b["coord"], b["cell"],
                                 b["gt_lr_up"])
        z_init = jprior.apply(prior_params, z_lr, inp, training=False)
        return [jm.query_rgb(params, inp, feat, b["coord"], b["cell"], zmap=z)
                for z in (z_lr, z_init)]

    for name, pred in zip(("no prior", "init"),
                          jax_preds(jm.params, jprior.params, ebatch)):
        assert psnr[name] == pytest.approx(jc._psnr(pred, egt_norm),
                                           abs=PSNR_TOL_DB), name


# ---------------------------------------------------------------------------
# 2. SRFlow NLL training
# ---------------------------------------------------------------------------

def _pair_16(g, n):
    return task.srflow_pair(g, n, (4, 4), 4, 0.1, 2)


def test_srflow_nll_training_learns(rng, one_thread, jax_srflow):
    jm = jax_srflow

    def port_model():
        tm = registry.make(srflow_specs(tiny=True)[0])
        tm.load_state_dict(srflow_state_dict(_np_tree(jm.params), tm.plan))
        return tm

    tm = port_model()
    opt = clip_by_global_norm(_adam(tm.parameters(), 1e-3), 10.0)
    step = make_srflow_train_step(tm, opt, weight_fl=1.0,
                                  rrdb_unfreeze_step=0,
                                  generator=torch.Generator().manual_seed(0))
    batch = _t(_pair_16(rng, 4))
    init_nll, final_nll = _train(step, lambda i: batch, 250)
    # bits/dim must fall substantially (quantization noise bounds the floor)
    assert final_nll < init_nll - 1.0, (init_nll, final_nll)

    eb = _t(_pair_16(np.random.default_rng(7), 2))
    init = port_model()
    psnr_init = heat0_psnr(init, eb["LQ"], eb["GT"])
    psnr_trained = heat0_psnr(tm, eb["LQ"], eb["GT"])
    assert psnr_trained > psnr_init + 1.0, (psnr_trained, psnr_init)

    # held-out NLL also improves (generalization, not just memorization)
    noise = (torch.rand(eb["GT"].shape,
                        generator=torch.Generator().manual_seed(9)) - 0.5) / 32

    def nll(m):
        with torch.no_grad():
            cache = m.precompute_ft(m.rrdb_preprocess(eb["LQ"], False))
            return float(m.normal_flow_nll(eb["GT"], cache, noise)[1].mean())

    assert nll(tm) < nll(init) - 1.0, (nll(tm), nll(init))

    # the JAX model's heat-0 decode at the initial weights
    z0 = jm.sample_z(None, 0.0, 2, (4, 4))
    sr, _ = jax.jit(lambda p, lq: jm.reverse_flow(
        p, lq, z=z0, eps_std=0.0, key=jax.random.PRNGKey(1)))(
            jm.params, jnp.asarray(eb["LQ"].numpy()))
    assert psnr_init == pytest.approx(
        jc._psnr(np.clip(np.asarray(sr), 0, 1), eb["GT"].numpy()),
        abs=PSNR_TOL_DB)


# ---------------------------------------------------------------------------
# 3. SRModel pixel-criterion training
# ---------------------------------------------------------------------------

def test_sr_model_training_learns(rng, one_thread):
    spec = {"name": "rrdb", "args": {"nf": 8, "nb": 2, "gc": 4,
                                     "no_upsampling": False}}
    jm = jregistry.make(spec)

    def port_model():
        tm = registry.make(spec)
        tm.load_state_dict(rrdb_state_dict(_np_tree(jm.params)))
        return tm

    tm = port_model()
    step = make_sr_train_step(tm, _adam(tm.parameters(), 1e-3),
                              pixel_criterion="l1")
    batch = _t(_pair_16(rng, 4))
    init_loss, final_loss = _train(step, lambda i: batch, 200)
    assert final_loss < 0.25 * init_loss, (init_loss, final_loss)

    eb = _t(_pair_16(np.random.default_rng(11), 2))
    with torch.no_grad():
        p_tr, p_in = (task.psnr(torch.clamp(m(eb["LQ"], kernels=False), 0, 1),
                                eb["GT"]) for m in (tm, port_model()))
    assert p_tr > p_in + 3.0, (p_tr, p_in)
    sr_init = jm.apply(jm.params, jnp.asarray(eb["LQ"].numpy()))
    assert p_in == pytest.approx(
        jc._psnr(np.clip(np.asarray(sr_init), 0, 1), eb["GT"].numpy()),
        abs=PSNR_TOL_DB)


# ---------------------------------------------------------------------------
# 4. SRFlow-LP latent-module (prior) training
# ---------------------------------------------------------------------------

def _pair_32(g, n):
    return task.srflow_pair(g, n, (8, 8), 4, 0.18, 2)


def test_srflow_prior_training_learns(rng, one_thread, jax_srflow):
    jm = jax_srflow
    jprior = jregistry.make({"name": "srflow-unet", "args": {"depth": 2,
                                                            "dim": 16}})
    batch = _pair_32(rng, 4)
    # the JAX test's data-dependent actnorm init on its first batch,
    # carried across with the rest of its weights
    jparams = jax.jit(jm.prime_actnorms)(jm.params, jnp.asarray(batch["GT"]),
                                         jnp.asarray(batch["LQ"]))
    tm = load_srflow(registry.make(srflow_specs(tiny=True)[0]),
                     _np_tree(jparams))
    prior_spec = {"name": "srflow-unet", "args": {"depth": 2, "dim": 16}}

    def port_prior():
        return load_srflow_unet(registry.make(prior_spec),
                                _np_tree(jprior.params))

    prior = port_prior().train()
    opt = _adam(prior.parameters(), 2e-3)
    step = make_srflow_prior_train_step(tm, prior, opt, eps_weight=1.0,
                                        image_weight=2.0)
    # FRESH pairs every step: the prior must learn the rule, not the batch
    init_loss, final_loss = _train(step, lambda i: _t(_pair_32(rng, 4)), 700)
    assert final_loss < 0.5 * init_loss, (init_loss, final_loss)

    eb = _t(_pair_32(np.random.default_rng(29), 2))
    psnr = decode_psnrs(tm, {"no prior": None, "init": port_prior(),
                             "trained": prior.eval().freeze()},
                        eb["LQ"], eb["GT"])
    assert psnr["trained"] > psnr["no prior"] + 2.0, psnr
    assert psnr["trained"] > psnr["init"] + 2.0, psnr

    # the JAX eval contract at the initial prior, on the same images
    @jax.jit
    def jax_decodes(params, prior_params, lq):
        epses_lr, _, _ = jm.normal_flow(params, j_resize_bilinear(lq, (32, 32)),
                                        lq, add_gt_noise=False,
                                        want_logdet=False)
        learned = jprior.apply(prior_params, j_standardize(epses_lr))
        return [jm.reverse_flow(params, lq, epses=e, add_gt_noise=False,
                                want_logdet=False)[0]
                for e in (epses_lr, learned)]

    for name, sr in zip(("no prior", "init"), jax_decodes(
            jparams, jprior.params, jnp.asarray(eb["LQ"].numpy()))):
        assert psnr[name] == pytest.approx(
            jc._psnr(np.clip(np.asarray(sr), 0, 1), eb["GT"].numpy()),
            abs=PSNR_TOL_DB), name
