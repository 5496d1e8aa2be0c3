"""Port parity for the whole SRFlow-LP prior train step, on the CPU: the
port's ``make_srflow_prior_train_step`` against
``bfsr_tpu.pipelines.srflow_prior_train.make_srflow_prior_train_step`` on
the same weights (through ``convert/from_jax.py``) and the same batch, at
the tiny config of ``tests/test_srflow_train_cli.py`` (RRDB nf 8, nb 2, gc
4; K 2, L 3, hidden 8; prior depth 2 / dim 8), with the eps loss, the
image loss and both: the losses, the prior's gradients tensor by tensor
and the BatchNorm running stats after one step; one Adam step; the step
under ``mixed`` and ``default``; the kernel path against the twin path;
and the CLI.  The JAX step's optimizer hands back the gradients it is
given as its state and updates nothing, so one JAX step yields the loss,
the gradients and the running stats.

The steps take B 2 of 64^2 GT crops, where the CLI test's 32^2 would leave
the final-latent branch's deepest BatchNorm two values to normalise (B 2
at 1 x 1): there the JAX step's own gradients move by up to 6e-4 of a
tensor's largest value under a 1e-7 scaling of LQ, and by 85% in relative
L2 under 2^-9, so no comparison at the 1e-4 level means anything.  At
64^2 (eight values: B 2 at 2 x 2) a 1e-7 scaling moves them by 2e-5 to
3.5e-5 in relative L2 and the port is 1.1e-5 to 2.6e-5 off JAX."""

import pickle

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bfsr_tpu.ops import nn as jnn
from bfsr_tpu.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step as j_make_step)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import (load_srflow_unet,
                                             srflow_unet_state_dict)
from bfsr_tpu_torch.entry import synthetic_lrhr_sample
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step)
from bfsr_tpu_torch.train.optim import make_optimizer

from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_srflow_models import _np_tree, tiny_pair
from test_torch_train_step import grad_capture

# (eps_weight, image_weight): the eps loss (the CLI's default), both, the
# image loss alone
WEIGHTS = [(1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
ADAM = {"lr": 1e-3, "betas": (0.9, 0.99)}


def batch(seed=0, n=2, gt_size=64):
    rng = np.random.default_rng(seed)
    samples = [synthetic_lrhr_sample(rng, gt_size) for _ in range(n)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def jax_steps():
    """One JAX step per loss weighting, and one Adam step with both
    losses, run once."""
    jm, jp, _, _ = tiny_pair()
    data = batch()
    results = {}
    for ew, iw in WEIGHTS:
        step = j_make_step(jm, jp, grad_capture(), ew, iw)
        new, grads, mets = step(jp.params, grad_capture().init(jp.params),
                                jm.params, _jbatch(data))
        results[ew, iw] = (_np_tree(new), _np_tree(grads),
                           {k: float(v) for k, v in mets.items()})
    adam = optax.adam(ADAM["lr"], b1=ADAM["betas"][0], b2=ADAM["betas"][1])
    new, _, _ = j_make_step(jm, jp, adam, 1.0, 1.0)(
        jp.params, adam.init(jp.params), jm.params, _jbatch(data))
    results["adam"] = _np_tree(new)
    return data, results


def port_prior():
    _, jp, _, tp = tiny_pair()
    return load_srflow_unet(registry.make(tp.spec()),
                            _np_tree(jp.params)).train()


def port_step(prior, ew=1.0, iw=1.0, kernels=True, lr=1e-4):
    _, _, tm, _ = tiny_pair()
    opt = make_optimizer({"name": "adam", "args": {**ADAM, "lr": lr}},
                         prior.parameters())
    return make_srflow_prior_train_step(tm, prior, opt, ew, iw,
                                        kernels=kernels)


@pytest.mark.parametrize("eps_weight,image_weight", WEIGHTS)
def test_prior_step_matches_jax(jax_steps, eps_weight, image_weight):
    data, results = jax_steps
    new_params, jgrads, jmets = results[eps_weight, image_weight]
    prior = port_prior()
    step = port_step(prior, eps_weight, image_weight)
    mets, grads, _ = step.loss_and_grads(data)
    assert set(mets) == set(jmets)
    for k in mets:
        np.testing.assert_allclose(float(mets[k]), jmets[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref = srflow_unet_state_dict(jgrads)
    assert set(grads) <= set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    got = step(data)
    np.testing.assert_allclose(got["loss"], jmets["loss"], rtol=1e-5)
    want = srflow_unet_state_dict(new_params)
    n = 0
    for name, t in prior.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=name)
            n += 1
    assert n == 2 * 2 * 10


def test_adam_step_matches_jax(jax_steps):
    """One step through the real optimizers (torch's Adam against
    ``optax.adam``, lr 1e-3, betas (0.9, 0.99)).  A first Adam step moves
    each parameter by lr g / (|g| + eps): lr times the sign of its gradient
    wherever |g| >> eps, so two gradients that agree to 1e-4 of their
    largest value give the same step except where a component is within
    that of zero; those move by at most 2 lr."""
    data, results = jax_steps
    prior = port_prior()
    before = {k: v.detach().clone() for k, v in prior.state_dict().items()}
    port_step(prior, lr=ADAM["lr"])(data)
    want = srflow_unet_state_dict(results["adam"])
    lr, near = ADAM["lr"], []
    for name, p in prior.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got, ref, atol=2 * lr + 1e-6, rtol=0,
                                   err_msg=name)
        near.append(np.abs(got - ref) > 1e-3 * lr)
        assert not np.array_equal(got, before[name].numpy()), name
    assert np.concatenate([m.ravel() for m in near]).mean() < 1e-2


@pytest.mark.parametrize("mode", ["high", "mixed", "default"])
def test_kernel_path_is_the_twin_path_on_cpu(restore_modes, mode):
    """On CPU tensors the kernel path runs the twins (``FlowStepReverse``
    included): the two paths give the same loss and gradients, bit for
    bit, in every mode."""
    data = batch(1)
    tnn.set_default_precision(mode)
    outs = [port_step(port_prior(), kernels=k).loss_and_grads(data)
            for k in (True, False)]
    for k in outs[0][0]:
        assert torch.equal(outs[0][0][k], outs[1][0][k]), k
    for name in outs[0][1]:
        assert torch.equal(outs[0][1][name], outs[1][1][name]), name


def _global_rel_l2(grads, ref):
    g = torch.cat([grads[k].flatten() for k in grads])
    r = torch.cat([torch.as_tensor(np.asarray(ref[k])).flatten()
                   for k in grads])
    return float((g - r).norm() / r.norm())


def _bf16_valued_share(grads):
    """The share of the conv-weight gradient elements that are bf16
    values: an f32 sum of products is one only by chance, a gradient
    rounded on its way back always is."""
    ws = [g for g in grads.values() if g.dim() == 4]
    return sum(float((tnn.round_bf16(g) == g).float().mean())
               for g in ws) / len(ws)


@pytest.mark.parametrize("mode", ["mixed", "default"])
def test_prior_step_in_a_bf16_mode_matches_jax(restore_modes, mode):
    """Both losses under ``mixed`` (the prior's convs on bf16 operands,
    forward and backward) and ``default`` (every stage: the RRDB, the
    records, K5's one-pass form in both encodes and the decode) against
    the JAX step in the same mode.  On the CPU XLA computes DEFAULT in f32,
    so this is a smoke test: the loss within 2^-8 relative (each rounded
    operand carries at most 2^-9; the mode moves this loss by 0.06% to
    0.15%), the gradients within 0.5 in relative L2 (half the distance of a
    zero gradient, as ``chip_smoke.py`` holds a mode's trainable part: a
    mode moves this step's gradients by 0.13 to 0.22, several times its
    f32 spread under a coherent 2^-9 scaling of LQ, since it rounds every
    operand of 96 flow steps and the prior on its own), the conv-weight
    gradients unrounded (the backward rule of ``ops/nn.py``), and the mode
    visibly rounded."""
    jm, jp, _, _ = tiny_pair()
    data = batch(2)
    prior = port_prior()
    step = port_step(prior)
    high, high_grads, _ = step.loss_and_grads(data)

    jnn.set_default_precision(mode)
    tnn.set_default_precision(mode)
    _, jgrads, jmets = j_make_step(jm, jp, grad_capture(), 1.0, 1.0)(
        jp.params, grad_capture().init(jp.params), jm.params, _jbatch(data))
    mets, grads, _ = step.loss_and_grads(data)
    ref = srflow_unet_state_dict(_np_tree(jgrads))
    loss, jloss = float(mets["loss"]), float(jmets["loss"])
    assert abs(loss - jloss) <= 2.0 ** -8 * abs(jloss)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert _global_rel_l2(grads, ref) <= 0.5
    assert _bf16_valued_share(grads) < 0.5
    assert loss != float(high["loss"])
    assert _global_rel_l2(grads, high_grads) > 1e-4


def test_steps_move_every_parameter_and_keep_losses_finite():
    prior = port_prior()
    before = {k: v.detach().clone() for k, v in prior.named_parameters()}
    step = port_step(prior, lr=1e-3)
    losses = [step(batch(seed, gt_size=32))["loss"] for seed in range(3)]
    assert np.isfinite(losses).all()
    for k, v in prior.named_parameters():
        assert not torch.equal(v, before[k]), k


def _conf(tmp_path):
    import yaml

    rng = np.random.default_rng(2)
    hrs = [(rng.random((32, 32, 3)) * 255).astype(np.uint8) for _ in range(6)]
    lqs = [(rng.random((8, 8, 3)) * 255).astype(np.uint8) for _ in range(6)]
    paths = {}
    for name, data in (("gt", hrs), ("lq", lqs)):
        paths[name] = str(tmp_path / f"{name}.pklv4")
        with open(paths[name], "wb") as f:
            pickle.dump(data, f)
    conf = {
        "name": "prior_smoke", "scale": 4,
        "datasets": {"train": {"mode": "LRHR_PKL", "dataroot_GT": paths["gt"],
                               "dataroot_LQ": paths["lq"], "quant": 32,
                               "batch_size": 2, "n_workers": 1,
                               "use_flip": True}},
        "network_G": {"in_nc": 3, "out_nc": 3, "nf": 8, "nb": 2, "gc": 4,
                      "flow": {"K": 2, "L": 3, "hidden_channels": 8,
                               "additionalFlowNoAffine": 2,
                               "split": {"enable": True}, "fea_up0": True,
                               "stackRRDB": {"blocks": [0, 1],
                                             "concat": True}}},
        "prior_model": {"name": "unet", "args": {"depth": 2, "dim": 8}},
        "path": {"resume_state": "auto"},
        "train": {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.99,
                  "lr_scheme": "MultiStepLR", "lr_steps_rel": [0.5],
                  "lr_gamma": 0.5, "niter": 3, "weight_eps": 1.0,
                  "weight_img": 1.0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2}}
    path = tmp_path / "prior_conf.yml"
    path.write_text(yaml.safe_dump(conf))
    return str(path), conf


def test_cli_trains_saves_resumes_and_refuses_base_training(tmp_path,
                                                            monkeypatch):
    pytest.importorskip("yaml")
    import yaml

    from bfsr_tpu_torch.cli import srflow_train as cli
    from bfsr_tpu_torch.train import checkpoints as ckpt

    conf_path, conf = _conf(tmp_path)
    monkeypatch.chdir(tmp_path)
    cli.cli([conf_path, "--prior", "--device", "cpu"])
    save = tmp_path / "save" / "prior_smoke-prior"
    latest = str(save / "prior_latest.ckpt")
    sv = ckpt.load_checkpoint(latest)
    assert sv["iter"] == 3
    assert sv["optimizer"]["sd"]["state"][0]["step"] == 3
    assert (save / "prior_3.ckpt").exists()
    prior = registry.make(sv["prior_model"])
    prior.load_state_dict(sv["prior_model"]["sd"])
    assert prior.registry_name == "srflow-unet"
    for t in sv["prior_model"]["sd"].values():
        assert torch.isfinite(t.float()).all()
    log = (save / "log.txt").read_text()
    assert "priming actnorms" in log and "iter 2: eps_l=" in log
    # auto-resume continues from the newest prior_ checkpoint
    cli.cli([conf_path, "--prior", "--device", "cpu", "--niter", "4"])
    sv = ckpt.load_checkpoint(latest)
    assert sv["iter"] == 4
    assert sv["optimizer"]["sd"]["state"][0]["step"] == 4
    assert "auto-resumed" in (save / "log.txt").read_text()
    # without --prior the conf trains the base model, and model: sr the
    # RRDB (tests/test_torch_srflow_train_cli.py runs both); neither is
    # refused any more
    called = []
    monkeypatch.setattr(cli, "train_srflow", lambda *a: called.append("base"))
    monkeypatch.setattr(cli, "train_sr", lambda *a: called.append("sr"))
    cli.cli([conf_path, "--device", "cpu"])
    sr = tmp_path / "sr.yml"
    sr.write_text(yaml.safe_dump(dict(conf, model="sr")))
    cli.cli([str(sr), "--prior", "--device", "cpu"])
    assert called == ["base", "sr"]
