"""The LINF learning curve's first steps, step by step against the JAX
curve's own trainer, on the CPU.

``bfsr_tpu_torch/profiling/train_curve.py`` and the JAX package's
``profiling/train_curve.py`` train the latent prior on the same task
(the same crops from ``default_rng(0)``, latent L1 alone, Adam), but each
from its own random weights.  Here both start from the JAX curve's
initial weights (``__graft_entry__._flagship(tiny=True)``: the tiny
flagship with its flow conditioned by + I, carried across by
``convert/from_jax.py``) and take the curve's steps on the curve's task
at a tiny size (LR 8^2 x2, 8 crops cycled in batches of 4): each step's
loss must follow the JAX step's within ``STEP_RTOL``.  The losses fall,
so the latent loss's backward and the Adam step carry over step after
step, not only for the one step of ``tests/test_torch_train_step.py``.
The curve's own learning rate and a 20x larger one (the convergence
test's) are both held."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from __graft_entry__ import _flagship
from bfsr_tpu.pipelines.linf_train import make_train_step as j_make_train_step
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_linf, load_unet
from bfsr_tpu_torch.entry import flagship_specs
from bfsr_tpu_torch.pipelines.linf_train import make_train_step, to_device
from bfsr_tpu_torch.profiling import learnable_task as task
from bfsr_tpu_torch.profiling import train_curve

from test_torch_srflow_models import _np_tree

LR_SIZE, BATCH, N_TRAIN, STEPS = 8, 4, 8, 20
LRS = [train_curve.LR, 2e-3]
# f32 on both sides, the sums in another order.  The first steps agree to
# the rounding; after them the Adam steps carry each step's rounding into
# the next, and the two trajectories part as far as the JAX curve's own
# trajectory parts from itself when its initial weights move by ~1 ulp
# (x (1 + NUDGE * N(0, 1)), NUDGES draws): the port must stay within
# SPREAD_FACTOR x that spread, as chip_smoke.py holds a step's kernel path
# to its twin path
EXACT_STEPS, EXACT_RTOL = 4, 1e-5
NUDGE, NUDGES, SPREAD_FACTOR = 1e-7, 3, 2.0


def _batches():
    """The curve's crops at LR 8^2: ``default_rng(SEED)``, the checker of
    period 3 at amp 0.15, cycled in batches of 4."""
    H = LR_SIZE * train_curve.SCALE
    pattern = task.checker(H, H, train_curve.PERIOD)
    lrs = task.smooth_lr(np.random.default_rng(train_curve.SEED), N_TRAIN,
                         LR_SIZE, LR_SIZE)
    return [task.linf_batch(lrs[i:i + BATCH], pattern, train_curve.SCALE,
                            train_curve.AMP)[0]
            for i in range(0, N_TRAIN, BATCH)]


def _rel(a, b):
    return np.abs(np.asarray(a) / np.asarray(b) - 1.0)


@pytest.fixture(scope="module")
def jax_curve():
    """The JAX curve's models at their initial weights, the batches, and
    for each learning rate the JAX curve's losses and their largest
    relative move under the nudges (the step jitted once: the rate is a
    hyperparameter of the optimizer's state)."""
    jm, jprior = _flagship(tiny=True)
    batches = _batches()
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LRS[0])
    step = j_make_train_step(jm, jprior, None, opt, vgg_weight=0.0,
                             latent_weight=1.0)

    def losses(lr, params):
        state = opt.init(params)
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        out = []
        for i in range(STEPS):
            params, state, mets = step(params, state, jm.params, {},
                                       jbatches[i % len(jbatches)])
            out.append(float(mets["latent_l"]))
        return np.asarray(out)

    rng = np.random.default_rng(0)
    curves = {}
    for lr in LRS:
        ref = losses(lr, jprior.params)
        spread = max(_rel(losses(lr, jax.tree_util.tree_map(
            lambda p: p * (1 + NUDGE * rng.standard_normal(p.shape)
                           ).astype(np.float32), jprior.params)), ref).max()
            for _ in range(NUDGES))
        curves[lr] = ref, spread
    return jm, jprior, batches, curves


@pytest.mark.parametrize("lr", LRS)
def test_curve_steps_follow_the_jax_curve(jax_curve, lr):
    jm, jprior, batches, curves = jax_curve
    jlosses, spread = curves[lr]
    linf_spec, prior_spec = flagship_specs(tiny=True)
    linf = load_linf(registry.make(linf_spec), _np_tree(jm.params))
    prior = load_unet(registry.make(prior_spec),
                      _np_tree(jprior.params)).train()
    step = make_train_step(linf, prior, None,
                           torch.optim.Adam(prior.parameters(), lr=lr),
                           vgg_weight=0.0, latent_weight=1.0)
    tb = [to_device(b, "cpu") for b in batches]
    losses = np.asarray([step(tb[i % len(tb)])["loss"]
                         for i in range(STEPS)])
    np.testing.assert_allclose(losses[:EXACT_STEPS], jlosses[:EXACT_STEPS],
                               rtol=EXACT_RTOL, atol=0)
    assert _rel(losses, jlosses).max() <= SPREAD_FACTOR * spread, (
        _rel(losses, jlosses), spread)
    # the steps learn: the last batch's loss against its first visit
    assert jlosses[-1] < 0.9 * jlosses[1], jlosses
