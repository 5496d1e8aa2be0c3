"""Port parity for the latent modules beside the UNet on the CPU:
``swin_latent`` (at its fixed widths, on a z whose sides pad to a window
multiple, so the layer's shift mask spans several windows) in eval and
training form, its stochastic depth held statistically,
``edsr-baseline-latent``, their weights across the JAX bridge, the LINF
predictor with a Swin prior against the JAX predictor (K1 and K2 in
interpret mode there), and one trainer step with a Swin prior against the
JAX ``make_train_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)
from bfsr_tpu import registry as jregistry
from bfsr_tpu.convert import torch_import as cv
from bfsr_tpu.models.swin_latent import swin_latent_apply
from bfsr_tpu.pipelines.linf_eval import LINFPredictor as JPredictor
from bfsr_tpu.pipelines.linf_train import make_train_step as j_make_train_step
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert import from_jax
from bfsr_tpu_torch.entry import SWIN_PRIOR, build_swin_prior, flagship_specs
from bfsr_tpu_torch.models import swinir
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
from bfsr_tpu_torch.pipelines.linf_train import make_train_step
from bfsr_tpu_torch.train.optim import make_optimizer

from test_torch_train_step import NORM, VGG, batch, grad_capture

ATOL = 2e-5
PIPE_IMAGE = 1e-3
EDSR_LATENT = {"name": "edsr-baseline-latent",
               "args": {"in_chans": 3, "n_resblocks": 2}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def swin():
    """(JAX swin_latent, the port's on the same weights, z (2, 10, 9, 3),
    lr (2, 4, 3, 3)): z pads to 14 x 14, four windows of 7."""
    jm = jregistry.make(SWIN_PRIOR)
    tm = from_jax.load_prior(registry.make(SWIN_PRIOR), _np(jm.params))
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 10, 9, 3)).astype(np.float32)
    lr = rng.random((2, 4, 3, 3)).astype(np.float32)
    return jm, tm, z, lr


def test_swin_latent_matches_jax(swin):
    jm, tm, z, lr = swin
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(z), jnp.asarray(lr)))
    t = torch.from_numpy
    with torch.no_grad():
        for kernels in (True, False):
            got = tm(t(z), t(lr), kernels=kernels).numpy()
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert ref.shape == z.shape


def test_swin_latent_training_form_at_rate_0_matches_jax(swin):
    """The training form with a generator at drop_path_rate 0 against the
    JAX module with a key at rate 0: the output and ``{}``."""
    jm, tm, z, lr = swin
    ref = np.asarray(swin_latent_apply(jm.params, jnp.asarray(z),
                                       jnp.asarray(lr), 7,
                                       key=jax.random.PRNGKey(1),
                                       drop_path_rate=0.0))
    tm.drop_path_rate = 0.0
    try:
        got, stats = tm(torch.from_numpy(z), torch.from_numpy(lr),
                        training=True,
                        generator=torch.Generator().manual_seed(1))
    finally:
        tm.drop_path_rate = 0.1
    assert stats == {}
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL, rtol=0)


def test_drop_path_is_per_sample_scaled_and_seeded():
    """timm's rule: each sample whole kept (scaled by 1 / keep) or zeroed,
    kept at rate keep (within 5 sigma over 4000 samples), the same draws
    from the same generator state."""
    x = torch.rand((4000, 3, 2, 2)) + 0.5
    rate = 0.25
    out = swinir.drop_path(x, rate, torch.Generator().manual_seed(0))
    ratio = (out / x).reshape(4000, -1)
    kept = ratio[:, 0] > 0
    torch.testing.assert_close(ratio[kept], torch.full_like(ratio[kept],
                                                            1 / 0.75))
    assert float(ratio[~kept].abs().max()) == 0.0
    frac = float(kept.float().mean())
    assert abs(frac - 0.75) < 5 * (0.75 * 0.25 / 4000) ** 0.5
    again = swinir.drop_path(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert swinir.drop_path(x, 0.0, torch.Generator()) is x
    assert swinir.drop_path(x, rate, None) is x


def test_stochastic_depth_rates_by_block(swin, monkeypatch):
    """Each of the 12 blocks draws both residuals at its rate of
    ``linspace(0, 0.1, 12)`` (the JAX module's ``dpr``), in training form
    only; a seeded generator gives the same output twice."""
    _, tm, z, lr = swin
    seen = []
    draw = swinir.drop_path

    def record(x, rate, generator):
        seen.append((rate, generator is not None))
        return draw(x, rate, generator)

    monkeypatch.setattr(swinir, "drop_path", record)
    t = torch.from_numpy
    with torch.no_grad():
        a, _ = tm(t(z), t(lr), training=True,
                  generator=torch.Generator().manual_seed(3))
        want = [(float(r), True) for r in np.linspace(0, 0.1, 12)
                for _ in range(2)]
        assert seen == want
        seen.clear()
        ev = tm(t(z), t(lr), generator=torch.Generator().manual_seed(3))
        assert all(not g for _, g in seen)
        b, _ = tm(t(z), t(lr), training=True,
                  generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, ev)


def test_swin_attention_products_round_in_a_bf16_stage(rng):
    a = torch.from_numpy(rng.standard_normal((2, 3, 5, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 3, 4, 6)).astype(np.float32))
    saved = fnn.precision_mode()
    try:
        fnn.set_default_precision("default")
        got = fnn.matmul(a, b)
    finally:
        fnn.set_default_precision(saved)
    torch.testing.assert_close(got, torch.matmul(fnn.round_bf16(a),
                                                 fnn.round_bf16(b)),
                               rtol=0, atol=0)
    assert not torch.equal(got, torch.matmul(a, b))


def test_edsr_latent_matches_jax(rng):
    jm = jregistry.make(EDSR_LATENT)
    tm = from_jax.load_prior(registry.make(EDSR_LATENT), _np(jm.params))
    z = rng.standard_normal((2, 8, 7, 3)).astype(np.float32)
    lr = rng.random((2, 3, 3, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(z), jnp.asarray(lr)))
    t = torch.from_numpy
    with torch.no_grad():
        for kernels in (True, False):
            np.testing.assert_allclose(tm(t(z), t(lr), kernels=kernels).numpy(),
                                       ref, atol=ATOL, rtol=0)
    got, stats = tm(t(z), t(lr), training=True)
    assert stats == {}
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL, rtol=0)
    # the K3 convs keep their layouts: both dense blocks and the body
    assert all(c.kweight is not None for c in tm._k3_convs())
    assert len(tm._k3_convs()) == 10 + 4


@pytest.mark.parametrize("name", ["swin_latent", "edsr-baseline-latent"])
def test_latent_weights_round_trip_through_the_jax_bridge(name):
    spec = SWIN_PRIOR if name == "swin_latent" else EDSR_LATENT
    m = registry.make(spec)
    m.reset_parameters(torch.Generator().manual_seed(2))
    sd = m.state_dict()
    params = (cv.convert_swin_latent(sd) if name == "swin_latent"
              else cv.convert_edsr_latent(sd, 2))
    back = from_jax.PRIOR_STATE_DICTS[name](_np(params))
    assert set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


def test_a_reference_state_dict_with_swin_buffers_loads():
    """The reference's persistent ``relative_position_index`` and
    ``attn_mask`` buffers are recomputed here: a state_dict that carries
    them loads."""
    m = registry.make(SWIN_PRIOR)
    sd = dict(m.state_dict())
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(49, 49)
    sd["layers.0.blocks.1.attn_mask"] = torch.zeros(4, 49, 49)
    registry.make(SWIN_PRIOR).load_state_dict(sd)


def _jax_linf():
    jm = jregistry.make(flagship_specs(tiny=True)[0])
    jm.params["imnet"]["w"] = jm.params["imnet"]["w"] + jnp.eye(3)[None]
    return jm.freeze()


def test_linf_with_a_swin_prior_matches_the_jax_predictor(swin, rng):
    """``LINFPredictor.predict`` on the tiny flagship LINF with the Swin
    prior (path B's shape) against the JAX predictor on its Pallas path
    (K1 and K2 in interpret mode), within the pipeline's image
    tolerance."""
    jprior, tprior, _, _ = swin
    jm = _jax_linf()
    tm = from_jax.load_linf(registry.make(flagship_specs(tiny=True)[0]),
                            _np(jm.params))
    h, w, H, W = 5, 4, 10, 9
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    coord = make_coord_np((H, W), flatten=False)[None]
    cell = make_cell((H, W))[None]
    gt = (rng.random((1, H, W, 3)) - 0.5).astype(np.float32)
    ref = JPredictor(jm, jprior, tile_queries=128, use_pallas=True).predict(
        jm.params, jprior.params, jnp.asarray(inp), jnp.asarray(coord),
        jnp.asarray(cell), jnp.asarray(gt))
    t = torch.from_numpy
    for kernels in (True, False):
        got = LINFPredictor(tm, tprior, kernels=kernels).predict(
            t(inp), t(coord), t(cell), t(gt))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=PIPE_IMAGE)
    # build_swin_prior (path B) at its tiny size runs the same chain
    model, prior = build_swin_prior("cpu", tiny=True)
    assert prior.registry_name == "swin_latent"
    out = LINFPredictor(model, prior).predict(t(inp), t(coord), t(cell),
                                              t(gt))
    assert out.shape == (1, H, W, 3) and torch.isfinite(out).all()


def test_train_step_with_a_swin_prior_matches_jax(swin):
    """One ``make_train_step`` step with the Swin prior (stochastic depth
    at rate 0, drawn from a generator) against the JAX step (no key): the
    losses and the prior's gradients, tensor by tensor, as
    ``test_torch_train_step`` holds the UNet's."""
    jprior, _, _, _ = swin
    from test_torch_train_parts import port_linf, small_jax_linf

    jm = small_jax_linf()
    jvgg = jregistry.make(VGG)
    data = batch()
    step = j_make_train_step(jm, jprior, jvgg, grad_capture(),
                             vgg_weight=1.0, latent_weight=1.0,
                             data_norm=NORM)
    opt = grad_capture()
    _, jgrads, jmets = step(jprior.params, opt.init(jprior.params),
                            jm.params, jvgg.params,
                            {k: jnp.asarray(v) for k, v in data.items()})
    prior = from_jax.load_prior(registry.make(SWIN_PRIOR),
                                _np(jprior.params)).train()
    prior.drop_path_rate = 0.0
    vgg = from_jax.load_vgg(registry.make(VGG), _np(jvgg.params))
    tstep = make_train_step(
        port_linf(jm), prior, vgg.requires_grad_(False),
        make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                       prior.parameters()),
        vgg_weight=1.0, latent_weight=1.0, data_norm=NORM,
        generator=torch.Generator().manual_seed(0))
    mets, grads, bn_stats = tstep.loss_and_grads(data)
    assert bn_stats == {}
    for k in ("loss", "vgg_l", "latent_l"):
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]),
                                   rtol=1e-5, atol=1e-7)
    ref = from_jax.swin_latent_state_dict(_np(jgrads))
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    # a step moves the prior and keeps the loss finite
    before = prior.norm.weight.detach().clone()
    assert np.isfinite(tstep(data)["loss"])
    assert not torch.equal(before, prior.norm.weight)
