"""Port parity for the whole LINF-LP train step, on the CPU: the port's
``make_train_step`` against ``bfsr_tpu.pipelines.linf_train.make_train_step``
on the same weights (through ``convert/from_jax.py``) and the same batch,
without and with the latent loss: the loss, the prior's gradients tensor
by tensor, and the BatchNorm running stats after one step.  The JAX
step's optimizer here hands back the gradients it is given as its state
and updates nothing, so one JAX step yields the loss, the gradients and
the running stats."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bfsr_tpu import registry as jregistry
from bfsr_tpu.pipelines.linf_train import make_train_step as j_make_train_step
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_unet, load_vgg, unet_state_dict
from bfsr_tpu_torch.entry import synthetic_train_sample
from bfsr_tpu_torch.pipelines.linf_train import make_train_step
from bfsr_tpu_torch.train.optim import make_optimizer

from test_torch_train_parts import (SCALES, _np, port_linf, small_jax_linf)

UNET = {"name": "unet", "args": {"in_chans": 3, "depth": 2, "dim": 8,
                                 "bilinear": True}}
VGG = {"name": "VGGFeatureExtractor", "args": {"feature_layer": 8}}
NORM = {"inp": {"sub": [0.5], "div": [0.5]}, "gt": {"sub": [0.5],
                                                   "div": [0.5]}}
WEIGHTS = [(1.0, 0.0), (1.0, 1.0)]


def grad_capture():
    """An optax transformation whose state is the last gradients and whose
    updates are zero."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def batch(seed=0):
    """B = 2 crops of 8^2 from LR 8^2, one at each of SCALES."""
    rng = np.random.default_rng(seed)
    samples = [synthetic_train_sample(rng, inp_size=8, scale=s)
               for s in SCALES]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer's models and one step per loss weighting, run once."""
    jm = small_jax_linf()
    jprior = jregistry.make(UNET)
    jvgg = jregistry.make(VGG)
    data = batch()
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    results = {}
    for vw, lw in WEIGHTS:
        step = j_make_train_step(jm, jprior, jvgg, grad_capture(),
                                 vgg_weight=vw, latent_weight=lw,
                                 data_norm=NORM)
        opt = grad_capture()
        new_params, grads, mets = step(jprior.params,
                                       opt.init(jprior.params), jm.params,
                                       jvgg.params, jbatch)
        results[(vw, lw)] = (_np(new_params), _np(grads),
                             {k: float(v) for k, v in mets.items()})
    return jm, jprior, jvgg, data, results


def port_trainer(jm, jprior, jvgg):
    linf = port_linf(jm)
    prior = load_unet(registry.make(UNET), _np(jprior.params)).train()
    vgg = load_vgg(registry.make(VGG), _np(jvgg.params)).requires_grad_(False)
    return linf, prior, vgg


@pytest.mark.parametrize("vgg_weight,latent_weight", WEIGHTS)
def test_train_step_matches_jax(jax_trainer, vgg_weight, latent_weight):
    jm, jprior, jvgg, data, results = jax_trainer
    new_params, jgrads, jmets = results[(vgg_weight, latent_weight)]
    linf, prior, vgg = port_trainer(jm, jprior, jvgg)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    step = make_train_step(linf, prior, vgg, opt, vgg_weight=vgg_weight,
                           latent_weight=latent_weight, data_norm=NORM)

    mets, grads, _ = step.loss_and_grads(data)
    for k in ("loss", "vgg_l", "latent_l"):
        np.testing.assert_allclose(float(mets[k]), jmets[k], rtol=1e-5,
                                   atol=1e-7)
    assert jmets["loss"] > 0
    ref = unet_state_dict(jgrads)
    assert set(grads) <= set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)

    got = step(data)
    np.testing.assert_allclose(got["loss"], jmets["loss"], rtol=1e-5)
    want = unet_state_dict(new_params)
    for name, t in prior.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=name)


def test_twin_path_step_matches_kernel_path_on_cpu(jax_trainer):
    """On CPU tensors the kernel path runs the twins: the two paths give
    the same loss and gradients, bit for bit."""
    jm, jprior, jvgg, data, _ = jax_trainer
    linf, prior, vgg = port_trainer(jm, jprior, jvgg)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    outs = [make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                            data_norm=NORM, kernels=k).loss_and_grads(data)
            for k in (True, False)]
    for k in outs[0][0]:
        torch.testing.assert_close(outs[0][0][k], outs[1][0][k], rtol=0,
                                   atol=0)
    for name in outs[0][1]:
        torch.testing.assert_close(outs[0][1][name], outs[1][1][name],
                                   rtol=0, atol=0)


def test_steps_move_every_parameter_and_keep_losses_finite(jax_trainer):
    jm, jprior, jvgg, data, _ = jax_trainer
    linf, prior, vgg = port_trainer(jm, jprior, jvgg)
    before = {k: v.detach().clone() for k, v in prior.named_parameters()}
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-3}},
                         prior.parameters())
    step = make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                           data_norm=NORM)
    losses = [step(batch(seed))["loss"] for seed in range(3)]
    assert np.isfinite(losses).all()
    for k, v in prior.named_parameters():
        assert not torch.equal(v, before[k]), k
