"""Port parity for the LINF-LP patch trainer (ps = 3, d = 27), on the CPU
(the twins): the crop-patch wrapper against the JAX package's under the
same ``random.seed``, K2's twin on its centre axes against the JAX
2-D-gather info, the centre-grid check, the whole patch step against
``bfsr_tpu.pipelines.linf_train.make_train_step(patch=True)`` without and
with the latent loss, and the trainer CLI with ``--patch 3`` for an epoch
on PNGs that the test writes."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)
from bfsr_tpu import registry as jregistry
from bfsr_tpu.models.linf import linf_affine_info as j_info
from bfsr_tpu.pipelines.linf_train import make_train_step as j_make_train_step
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import (load_linf, load_unet, load_vgg,
                                             unet_state_dict)
from bfsr_tpu_torch.entry import synthetic_patch_train_sample
from bfsr_tpu_torch.pipelines.linf_train import (make_train_step,
                                                 patch_grid_axes)
from bfsr_tpu_torch.train.optim import make_optimizer

import bfsr_tpu_torch.data.wrappers  # noqa: F401  (registers)

from test_torch_train_parts import SCALES, _np
from test_torch_train_step import NORM, WEIGHTS, grad_capture

PS, INP = 3, 8     # LR crops of 24^2, 8^2 patch centres, HR windows of 24^2
PATCH_KEYS = ("inp", "coord", "cell", "gt", "gt_patch", "gt_lr_up",
              "interpolate_coord")
LINF_PATCH = {"name": "linf-patch", "args": {
    "encoder_spec": {"name": "edsr-baseline",
                     "args": {"n_resblocks": 2, "n_feats": 8,
                              "no_upsampling": True}},
    "imnet_spec": {"name": "flow", "args": {"name": "flow"}},
    "flow_layers": 2, "num_layer": 2, "hidden_dim": 16, "patch_size": PS}}
UNET = {"name": "unet", "args": {"in_chans": 3 * PS * PS, "depth": 2,
                                 "dim": 8, "bilinear": True}}
VGG = {"name": "VGGFeatureExtractor", "args": {"feature_layer": 8}}


def small_jax_patch():
    """EDSR 2 x 8, flow L = 2 at d = 27 (w * 0.05 + I), info MLP hidden 16,
    frozen."""
    m = jregistry.make(LINF_PATCH)
    m.params["imnet"]["w"] = (m.params["imnet"]["w"] * 0.05
                              + jnp.eye(3 * PS * PS)[None])
    return m.freeze()


def patch_batch(seed=0):
    """B = 2 crop-patch samples, one at each of SCALES."""
    rng = np.random.default_rng(seed)
    samples = [synthetic_patch_train_sample(rng, inp_size=INP, scale=s,
                                            ps=PS) for s in SCALES]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


@pytest.mark.parametrize("augment", [False, True])
def test_crop_patch_wrapper_matches_jax(augment):
    pytest.importorskip("PIL")
    from bfsr_tpu.data import wrappers as jwrappers

    img = np.random.default_rng(0).random((90, 84, 3)).astype(np.float32)
    args = {"inp_size": 6, "scale_max": 3, "augment": augment,
            "patch_size": PS}
    ours = registry.make({"name": "sr-implicit-downsampled-fast-crop-patch",
                          "args": {"dataset": [img], **args}})
    theirs = jwrappers.SRImplicitDownsampledFastCropPatch([img], **args)
    for seed in range(3):
        random.seed(seed)
        got = ours[0]
        random.seed(seed)
        want = theirs[0]
        assert set(got) == set(PATCH_KEYS) == set(want)
        assert got["gt_patch"].shape == (6, 6, 27)
        assert got["gt"].shape == got["inp"].shape == (18, 18, 3)
        for k in PATCH_KEYS:
            assert got[k].dtype == np.float32, k
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def patch_models():
    jm = small_jax_patch()
    return jm, load_linf(registry.make(LINF_PATCH), _np(jm.params))


def test_k2_twin_on_centre_axes_matches_jax_gather_info(patch_models):
    """The step's one-info premise for the patch model: K2's twin on the
    centre grids' axes is the JAX step's 2-D-gather info."""
    jm, tm = patch_models
    data = patch_batch(1)
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((len(SCALES), PS * INP, PS * INP, 8)) \
        .astype(np.float32)
    ref = np.asarray(j_info(jm.params, jnp.asarray(feat),
                            jnp.asarray(data["coord"]),
                            jnp.asarray(data["cell"]), jm.hidden_dim))
    t = torch.from_numpy
    cy, cx = patch_grid_axes(t(data["coord"]),
                             data["interpolate_coord"].shape[1:3], PS)
    got = tm.affine_info_grid(t(feat), cy, cx, t(data["cell"]))
    assert got.shape == (2 * 27 * 2, len(SCALES) * INP * INP)
    np.testing.assert_allclose(got.T.reshape(ref.shape).numpy(), ref,
                               atol=1e-6, rtol=0)


def test_patch_grid_axes_refuses_padded_and_irregular_grids():
    coord = torch.from_numpy(patch_batch(2)["coord"])
    cy, cx = patch_grid_axes(coord, (PS * INP, PS * INP), PS)
    torch.testing.assert_close(cy, coord[:, :, 0, 0], rtol=0, atol=0)
    torch.testing.assert_close(cx, coord[:, 0, :, 1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="padded"):
        patch_grid_axes(coord, (PS * INP + 1, PS * INP), PS)
    bent = coord.clone()
    bent[0, 3, 5, 0] += 1e-3
    with pytest.raises(ValueError, match="separable"):
        patch_grid_axes(bent, (PS * INP, PS * INP), PS)


@pytest.fixture(scope="module")
def jax_patch_trainer(patch_models):
    """The JAX patch step per loss weighting, run once."""
    jm, _ = patch_models
    jprior = jregistry.make(UNET)
    jvgg = jregistry.make(VGG)
    data = patch_batch()
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    results = {}
    for vw, lw in WEIGHTS:
        step = j_make_train_step(jm, jprior, jvgg, grad_capture(),
                                 vgg_weight=vw, latent_weight=lw,
                                 data_norm=NORM, patch=True)
        new_params, grads, mets = step(
            jprior.params, grad_capture().init(jprior.params), jm.params,
            jvgg.params, jbatch)
        results[(vw, lw)] = (_np(new_params), _np(grads),
                             {k: float(v) for k, v in mets.items()})
    return jprior, jvgg, data, results


def port_patch_trainer(patch_models, jprior, jvgg):
    _, linf = patch_models
    prior = load_unet(registry.make(UNET), _np(jprior.params)).train()
    vgg = load_vgg(registry.make(VGG), _np(jvgg.params)).requires_grad_(False)
    return linf, prior, vgg


@pytest.mark.parametrize("vgg_weight,latent_weight", WEIGHTS)
def test_patch_step_matches_jax(patch_models, jax_patch_trainer, vgg_weight,
                                latent_weight):
    jprior, jvgg, data, results = jax_patch_trainer
    new_params, jgrads, jmets = results[(vgg_weight, latent_weight)]
    linf, prior, vgg = port_patch_trainer(patch_models, jprior, jvgg)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    step = make_train_step(linf, prior, vgg, opt, vgg_weight=vgg_weight,
                           latent_weight=latent_weight, data_norm=NORM)

    mets, grads, _ = step.loss_and_grads(data)
    for k in ("loss", "vgg_l", "latent_l"):
        np.testing.assert_allclose(float(mets[k]), jmets[k], rtol=1e-5,
                                   atol=1e-7)
    assert jmets["loss"] > 0 and (jmets["latent_l"] > 0) == (latent_weight > 0)
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


def test_patch_twin_path_matches_kernel_path_on_cpu(patch_models,
                                                     jax_patch_trainer):
    """On CPU tensors the kernel path runs the twins: the same loss and
    gradients, bit for bit; and steps move every parameter."""
    jprior, jvgg, data, _ = jax_patch_trainer
    linf, prior, vgg = port_patch_trainer(patch_models, jprior, jvgg)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-3}},
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
    before = {k: v.detach().clone() for k, v in prior.named_parameters()}
    step = make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                           data_norm=NORM)
    losses = [step(patch_batch(seed))["loss"] for seed in range(2)]
    assert np.isfinite(losses).all()
    for k, v in prior.named_parameters():
        assert not torch.equal(v, before[k]), k


def test_cli_trains_a_patch_epoch(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    yaml = pytest.importorskip("yaml")
    from bfsr_tpu_torch.cli import train as cli
    from bfsr_tpu_torch.train import checkpoints as ckpt

    from test_torch_train_data import _config, _write_pngs

    root = str(tmp_path / "imgs")
    _write_pngs(root)
    monkeypatch.chdir(tmp_path)
    conf = _config(root, 1)
    # LR crops of 3 x 8 = 24^2 from HR crops of at most 48^2 (the PNGs
    # are 64^2)
    conf["train_dataset"]["wrapper"]["args"] = {"inp_size": INP,
                                                "scale_max": 2,
                                                "augment": True}
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(conf))
    cli.cli(["--config", str(cfg), "--name", "run", "--patch", str(PS),
             "--allow_random_vgg", "--device", "cpu"])
    save = tmp_path / "save" / "run"
    sv = ckpt.load_checkpoint(str(save / "prior_model-epoch-last.ckpt"))
    assert sv["epoch"] == 1
    assert sv["prior_model"]["args"]["in_chans"] == 27
    assert sv["optimizer"]["sd"]["state"][0]["step"] == 2
    written = yaml.safe_load((save / "config.yaml").read_text())
    wrapper = written["train_dataset"]["wrapper"]
    assert wrapper["name"] == "sr-implicit-downsampled-fast-crop-patch"
    assert wrapper["args"]["patch_size"] == PS
    assert written["model"]["name"] == "linf-patch"
    assert written["model"]["args"]["patch_size"] == PS
    assert "epoch 1/1" in (save / "log.txt").read_text()
