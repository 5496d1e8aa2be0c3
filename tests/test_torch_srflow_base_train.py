"""Port parity for SRFlow base-model training and validation, on the CPU:
the port's ``make_srflow_train_step`` against ``bfsr_tpu.pipelines.
srflow_train.make_srflow_train_step`` on the same weights (through
``convert/from_jax.py``), batch and quantisation noise (the noise the JAX
step draws from its key, passed to the port), at the tiny config of
``tests/test_srflow_train_and_measure.py`` (B 2 of 16^2 GT): the loss and
every parameter's gradient in the frozen form, the live form and with the
heat-0 L1; the frozen form against the mask form; three Adam steps across
the unfreeze; and ``validate`` against ``bfsr_tpu.pipelines.srflow_eval.
validate``.  The JAX step's optimizer hands back the gradients it is given
as its state and updates nothing, so one JAX step yields the loss and the
gradients.

Limits, as the prior trainer's test holds its step: the loss within 1e-5
relative, each gradient within 1e-4 of its tensor's largest value (and
exactly zero where JAX's is: the frozen RRDB, the x4 head the flow never
reads).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bfsr_tpu.pipelines.srflow_eval import sample_sr as j_sample_sr
from bfsr_tpu.pipelines.srflow_eval import validate as j_validate
from bfsr_tpu.pipelines.srflow_train import (
    make_srflow_train_step as j_make_step)
from bfsr_tpu_torch.convert.from_jax import srflow_state_dict
from bfsr_tpu_torch.pipelines import srflow_train
from bfsr_tpu_torch.pipelines.srflow_eval import sample_sr, validate
from bfsr_tpu_torch.train.optim import make_optimizer

from test_torch_srflow_models import _np_tree
from test_torch_srflow_nll import _jax_model, base_pair, batch, jax_noise
from test_torch_train_step import grad_capture

# (form, weight_l1): the frozen phase, the live phase, the live phase with
# the heat-0 L1
FORMS = [("frozen", 0.0), ("live", 0.0), ("live", 0.5)]
LR, BETAS = 1e-3, (0.9, 0.99)


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _jax_kwargs(form, unfreeze=0):
    return ({"freeze_rrdb": True} if form == "frozen"
            else {"rrdb_unfreeze_step": unfreeze})


@pytest.fixture(scope="module")
def jax_steps():
    """One JAX step per form, and three Adam steps of the mask form with
    the unfreeze at step 1, run once."""
    jm = _jax_model()
    results = {}
    data = batch()
    key = jax.random.PRNGKey(7)
    for form, wl1 in FORMS:
        step = j_make_step(jm, grad_capture(), 1.0, wl1,
                           **_jax_kwargs(form))
        _, grads, mets = step(jm.params, grad_capture().init(jm.params),
                              _jbatch(data), key, jnp.asarray(0))
        results[form, wl1] = (srflow_state_dict(_np_tree(grads), jm.plan),
                              {k: float(v) for k, v in mets.items()})
    adam = optax.adam(LR, b1=BETAS[0], b2=BETAS[1])
    step = j_make_step(jm, adam, 1.0, 0.0, rrdb_unfreeze_step=1)
    params, state = jm.params, adam.init(jm.params)
    for i in range(3):
        params, state, _ = step(params, state, _jbatch(batch(10 + i)),
                                jax.random.PRNGKey(20 + i), jnp.asarray(i))
    results["adam"] = srflow_state_dict(_np_tree(params), jm.plan)
    return data, jax_noise(key, data["GT"].shape), results


def port_step(model, form, wl1=0.0, unfreeze=0, lr=LR):
    opt = make_optimizer({"name": "adam", "args": {"lr": lr,
                                                   "betas": BETAS}},
                         model.parameters())
    kw = ({"freeze_rrdb": True} if form == "frozen"
          else {"rrdb_unfreeze_step": unfreeze})
    return srflow_train.make_srflow_train_step(model, opt, 1.0, wl1, **kw)


@pytest.mark.parametrize("form,weight_l1", FORMS)
def test_step_matches_jax(jax_steps, form, weight_l1):
    data, noise, results = jax_steps
    ref, jmets = results[form, weight_l1]
    _, tm = base_pair()
    mets, grads = port_step(tm, form, weight_l1).loss_and_grads(
        data, 0, torch.from_numpy(noise))
    assert set(mets) == set(jmets)
    for k in mets:
        np.testing.assert_allclose(float(mets[k]), jmets[k], rtol=1e-5,
                                   err_msg=k)
    assert set(grads) == set(ref)
    n_zero = 0
    for name, g in grads.items():
        r = ref[name].numpy()
        scale = np.abs(r).max()
        if scale == 0:
            assert not g.any(), name
            n_zero += 1
            continue
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    # the frozen RRDB; the x4 head (upconv2, HRconv, conv_last: weights
    # and biases), which the flow never reads
    n_rrdb = sum(k.startswith("RRDB.") for k in grads)
    assert n_zero == (n_rrdb if form == "frozen" else 6)


def test_frozen_form_equals_mask_form():
    """The frozen form (the RRDB under no_grad on K3's twin) and the live
    form masked before its unfreeze step give the same parameters over two
    Adam steps (the port's twin of ``test_srflow_frozen_step_matches_
    mask_form``)."""
    models = [base_pair()[1] for _ in range(2)]
    steps = [port_step(models[0], "frozen"),
             port_step(models[1], "live", unfreeze=100)]
    for i in range(2):
        noise = torch.from_numpy(jax_noise(jax.random.PRNGKey(i),
                                           (2, 16, 16, 3)))
        for step in steps:
            step(batch(i), i, noise)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=2e-7, err_msg=name)
    _, fresh = base_pair()
    for (name, a), b in zip(models[0].RRDB.named_parameters(),
                            fresh.RRDB.parameters()):
        assert torch.equal(a, b), name


def _three_adam_steps():
    """The port's frozen step at step 0, the live step at steps 1 and 2,
    on the JAX run's batches and noise; the model."""
    _, tm = base_pair()
    opt = make_optimizer({"name": "adam", "args": {"lr": LR, "betas": BETAS}},
                         tm.parameters())
    frozen = srflow_train.make_srflow_train_step(tm, opt, freeze_rrdb=True)
    live = srflow_train.make_srflow_train_step(tm, opt, rrdb_unfreeze_step=1)
    rrdb0 = {k: v.detach().clone() for k, v in tm.RRDB.named_parameters()}
    for i in range(3):
        noise = torch.from_numpy(jax_noise(jax.random.PRNGKey(20 + i),
                                           (2, 16, 16, 3)))
        (frozen if i < 1 else live)(batch(10 + i), i, noise)
        if i == 0:
            assert all(torch.equal(v, rrdb0[k])
                       for k, v in tm.RRDB.named_parameters())
    return tm


def _off_share(model, want, prefix=""):
    """Every parameter whose name starts with ``prefix`` within 2 lr + 1e-6
    of ``want``; returns the share of their elements more than 1e-3 lr
    off."""
    near = []
    for name, p in model.named_parameters():
        if not name.startswith(prefix):
            continue
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got, ref, atol=2 * LR + 1e-6, rtol=0,
                                   err_msg=name)
        near.append(np.abs(got - ref) > 1e-3 * LR)
    return np.concatenate([m.ravel() for m in near]).mean()


def test_three_adam_steps_across_the_unfreeze_match_jax(jax_steps,
                                                        monkeypatch):
    """Three steps, the unfreeze at step 1, against the JAX mask form under
    optax's one shared count.  Adam moves a parameter by about lr times
    the sign of its gradient, so two gradients that agree to 1e-4 give the
    same steps except at components within that of zero: the share of
    elements more than 1e-3 lr off stays under 1%.  The RRDB's first live
    update under a count of its own (torch's default: 1.0 x lr in place of
    0.74 x lr at count 2) moves most of its elements by ~0.26 lr, which
    this share refuses: shown by taking ``share_step_count`` away."""
    want = jax_steps[2]["adam"]
    tm = _three_adam_steps()
    _, fresh = base_pair()
    moved = [k for k, v in tm.RRDB.named_parameters()
             if not torch.equal(v, dict(fresh.RRDB.named_parameters())[k])]
    assert len(moved) == len(list(tm.RRDB.parameters())) - 6  # not the head
    assert _off_share(tm, want) < 1e-2
    assert _off_share(tm, want, "RRDB.") < 1e-2
    monkeypatch.setattr(srflow_train, "share_step_count", lambda opt: None)
    assert _off_share(_three_adam_steps(), want, "RRDB.") > 0.5


@pytest.fixture(scope="module")
def jax_validate():
    jm = _jax_model()
    data = [batch(30)]
    nll, samples = j_validate(jm, data, heats=(0.0, 0.5), n_sample=2)
    return data, nll, samples


def _jax_validate_noise(gt_shape, n_draws, seed=0):
    """The quantisation noise JAX's ``validate`` draws for its NLL: from
    the key left after ``n_draws`` splits for the samples, split once
    more."""
    key = jax.random.PRNGKey(seed)
    for _ in range(n_draws + 1):
        key, sub = jax.random.split(key)
    return torch.from_numpy(jax_noise(sub, gt_shape))


def test_validate_matches_jax_at_heat_0_and_is_seeded(jax_validate,
                                                      monkeypatch):
    """``validate``'s heat-0 samples (the kernel path: K3's and K5's twins
    here) against JAX's; its NLL on its own noise finite and near JAX's,
    and on JAX's noise (passed to ``normal_flow_nll``) within 1e-5
    relative of it; heat 0.5 the same under a seed and not under another,
    and ``kernels=False`` the same on the CPU."""
    data, jnll, jsamples = jax_validate
    _, tm = base_pair()
    nll, samples = validate(tm, data, heats=(0.0, 0.5), n_sample=2)
    for i in range(2):
        np.testing.assert_allclose(samples[0.0, i].numpy(),
                                   jsamples[0.0, i], atol=5e-4)
    assert np.isfinite(nll) and abs(nll - jnll) < 0.1 * abs(jnll)
    noise = _jax_validate_noise(data[0]["GT"].shape, 2 * 2)
    with monkeypatch.context() as m:
        m.setattr(tm, "normal_flow_nll",
                  functools.partial(tm.normal_flow_nll, noise=noise))
        fixed, _ = validate(tm, data, heats=(0.0, 0.5), n_sample=2)
    assert abs(fixed - jnll) <= 1e-5 * abs(jnll), (fixed, jnll)
    again = validate(tm, data, heats=(0.0, 0.5), n_sample=2)
    twins = validate(tm, data, heats=(0.0, 0.5), n_sample=2, kernels=False)
    other = validate(tm, data, heats=(0.5,), n_sample=1, seed=1)
    for res in (again, twins):
        assert res[0] == nll
        assert all(torch.equal(res[1][k], samples[k]) for k in samples)
    assert not torch.equal(samples[0.5, 0], samples[0.5, 1])
    assert not torch.equal(other[1][0.5, 0], samples[0.5, 0])


def test_validate_refreezes_weights_a_step_moved():
    """After a train step the K5 packs are stale: the kernel path refuses
    them, and ``validate`` lays them out again from the new weights."""
    _, tm = base_pair()
    port_step(tm, "frozen")(batch(4), 0)
    data = batch(5)
    gt, lq = torch.from_numpy(data["GT"]), torch.from_numpy(data["LQ"])
    with torch.no_grad():
        cache = tm.precompute_ft(tm.rrdb_preprocess(lq))
        with pytest.raises(RuntimeError, match="older than its weights"):
            tm.normal_flow(gt, cache)
        validate(tm, [data], heats=(0.0,), n_sample=1)
        tm.normal_flow(gt, tm.precompute_ft(tm.rrdb_preprocess(lq)))


def test_sample_sr_matches_jax_at_heat_0_and_is_seeded():
    """``sample_sr`` of an odd-sized LR (reflect-padded to even, cropped
    back) at heat 0 against JAX's; at heat 0.8 the same under a seed."""
    jm, tm = base_pair()
    lr = np.random.default_rng(31).random((5, 7, 3)).astype(np.float32)
    ref = j_sample_sr(jm, lr, heat=0.0)
    got = sample_sr(tm, lr, heat=0.0)
    assert got.shape == ref.shape == (20, 28, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)
    hot = [sample_sr(tm, lr, heat=0.8, seed=s) for s in (3, 3, 4)]
    assert torch.equal(hot[0], hot[1]) and not torch.equal(hot[0], hot[2])
