"""Port parity for the plain-SR path on the CPU: the ``'rrdb'`` model (the
trunk encoder and the x4 generator) against ``bfsr_tpu/models/rrdb.py``'s
``RRDBNet.apply``, ``make_sr_train_step`` with each pixel criterion and
``test_x8`` against ``bfsr_tpu/pipelines/sr_train.py``, and the GAN losses
against ``bfsr_tpu/pipelines/losses.py``, on the same weights (through
``convert/from_jax.py``), at nf 8, nb 2, gc 4 on B 2 of 8^2 LQ.

Tolerances: the model's output within 5e-5 (``docs/PARITY.md``'s module
level); a step's loss within 1e-5 relative and each gradient within 1e-4
of its tensor's largest value (the trainers' limits); the losses within
1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.pipelines import losses as jlosses
from bfsr_tpu.pipelines import sr_train as jsr
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import rrdb_state_dict
from bfsr_tpu_torch.pipelines import losses, sr_train
from bfsr_tpu_torch.train.optim import make_optimizer

from test_torch_srflow_models import _np_tree
from test_torch_train_step import grad_capture

ARGS = {"nf": 8, "nb": 2, "gc": 4}


def pair(no_upsampling):
    """(JAX RRDBNet, port 'rrdb' with its weights)."""
    spec = {"name": "rrdb", "args": {**ARGS, "no_upsampling": no_upsampling}}
    jm = jregistry.make(spec)
    tm = registry.make(spec)
    tm.load_state_dict(rrdb_state_dict(_np_tree(jm.params)))
    return jm, tm


def sr_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"LQ": rng.random((2, 8, 8, 3)).astype(np.float32),
            "GT": rng.random((2, 32, 32, 3)).astype(np.float32)}


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("no_upsampling", [True, False])
def test_rrdb_model_matches_jax(no_upsampling, kernels):
    jm, tm = pair(no_upsampling)
    lq = sr_batch()["LQ"]
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(lq)))
    with torch.no_grad():
        got = tm.freeze()(torch.from_numpy(lq), kernels=kernels)
    assert got.shape == ref.shape == ((2, 8, 8, 8) if no_upsampling
                                      else (2, 32, 32, 3))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=5e-5)
    assert set(tm.state_dict()) == set(rrdb_state_dict(_np_tree(jm.params)))


@pytest.mark.parametrize("criterion", ["l1", "l2", "cb"])
def test_sr_train_step_matches_jax(criterion):
    jm, tm = pair(False)
    data = sr_batch(1)
    step = jsr.make_sr_train_step(jm, grad_capture(), criterion, 0.5)
    _, jgrads, mets = step(jm.params, grad_capture().init(jm.params),
                           {k: jnp.asarray(v) for k, v in data.items()})
    ref = rrdb_state_dict(_np_tree(jgrads))
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         tm.parameters())
    tstep = sr_train.make_sr_train_step(tm, opt, criterion, 0.5)
    loss, grads = tstep.loss_and_grads(data)
    np.testing.assert_allclose(float(loss), float(mets["loss"]), rtol=1e-5)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max(),
                                   rtol=0, err_msg=name)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    assert np.isfinite(tstep(data)["loss"])
    assert all(not torch.equal(v, before[k])
               for k, v in tm.named_parameters())


def test_unknown_criterion_is_refused():
    _, tm = pair(False)
    with pytest.raises(NotImplementedError, match="huber"):
        sr_train.make_sr_train_step(tm, None, "huber")


def test_x8_matches_jax():
    jm, tm = pair(False)
    lq = np.random.default_rng(2).random((1, 8, 6, 3)).astype(np.float32)
    ref = np.asarray(jsr.test_x8(jm, jm.params, jnp.asarray(lq)))
    got = sr_train.test_x8(tm.freeze(), torch.from_numpy(lq))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("target_is_real", [True, False])
@pytest.mark.parametrize("gan_type", ["gan", "ragan", "lsgan", "wgan-gp"])
def test_gan_loss_matches_jax(gan_type, target_is_real):
    logits = np.random.default_rng(3).normal(0, 3, (4, 1, 5, 5)).astype(
        np.float32)
    ref = float(jlosses.gan_loss(gan_type, jnp.asarray(logits),
                                 target_is_real, 0.9, 0.1))
    got = float(losses.gan_loss(gan_type, torch.from_numpy(logits),
                                target_is_real, 0.9, 0.1))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses.gan_loss("hinge", torch.from_numpy(logits), target_is_real)


def test_gradient_penalty_matches_jax():
    """The penalty of a small nonlinear critic, and its gradient in the
    critic's weights (the penalty is built with a graph)."""
    rng = np.random.default_rng(4)
    x = rng.random((3, 4, 4, 2)).astype(np.float32)
    w = rng.normal(0, 1, (2, 5)).astype(np.float32)

    def j_critic(w):
        return lambda t: jnp.sum(jnp.tanh(t @ w) ** 2, axis=(1, 2, 3))

    ref, ref_g = jax.value_and_grad(
        lambda w: jlosses.gradient_penalty_loss(j_critic(w),
                                                jnp.asarray(x)))(
        jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    got = losses.gradient_penalty_loss(
        lambda t: torch.sum(torch.tanh(t @ tw) ** 2, (1, 2, 3)),
        torch.from_numpy(x))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-6)
