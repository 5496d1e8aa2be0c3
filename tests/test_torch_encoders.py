"""Port parity for LINF's other encoders on the CPU: RRDB (``rrdb_encode``),
RDN (configs A and B, with and without the upsampler), SwinIR (on an LR
whose sides are not a window multiple: the reflect pad and the padded
output), the full EDSR with its x2 / x3 / x4 upsamplers, and the MLP,
each against its JAX counterpart on the same weights; their weights
carried across the JAX bridge both ways; and ``LINFPredictor`` on an
RRDB encoder against the JAX predictor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)
from bfsr_tpu import registry as jregistry
from bfsr_tpu.convert import torch_import as cv
from bfsr_tpu.pipelines.linf_eval import LINFPredictor as JPredictor
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert import from_jax
from bfsr_tpu_torch.entry import rrdb_linf_specs
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

# docs/PARITY.md: a module's output, and the pipeline's features, latent
# and image
ATOL = 2e-5
PIPE = {"feat": 2e-5, "z": 5e-4, "image": 1e-3}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(spec, to_sd):
    """(JAX model, the port's model on the same weights) of ``spec``."""
    jm = jregistry.make(spec)
    tm = registry.make(spec)
    tm.load_state_dict(to_sd(_np(jm.params)))
    tm.eval()
    return jm, tm.freeze() if hasattr(tm, "freeze") else tm


def _check(jm, tm, x, atol=ATOL, **kw):
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    for kernels in (True, False):
        with torch.no_grad():
            got = tm(torch.from_numpy(x), kernels=kernels, **kw).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    return ref


def test_rrdb_encoder_matches_jax(rng):
    spec = {"name": "rrdb", "args": {"nf": 8, "nb": 2, "gc": 4,
                                     "no_upsampling": True}}
    jm, tm = _pair(spec, from_jax.rrdb_state_dict)
    x = rng.random((2, 7, 6, 3)).astype(np.float32)
    ref = _check(jm, tm, x)
    assert ref.shape == (2, 7, 6, 8) and tm.out_dim == 8


@pytest.mark.parametrize("config", ["A", "B"])
@pytest.mark.parametrize("no_upsampling,scale", [(True, 2), (False, 2),
                                                 (False, 3), (False, 4)])
def test_rdn_matches_jax(rng, config, no_upsampling, scale):
    spec = {"name": "rdn", "args": {"G0": 8, "RDNconfig": config,
                                    "scale": scale,
                                    "no_upsampling": no_upsampling}}
    jm, tm = _pair(spec, from_jax.rdn_state_dict)
    ref = _check(jm, tm, rng.random((1, 5, 4, 3)).astype(np.float32))
    s = 1 if no_upsampling else scale
    assert ref.shape == (1, 5 * s, 4 * s, 8 if no_upsampling else 3)


SWINIR = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window_size=4,
              num_feat=8)


def test_swinir_pads_to_the_window_and_matches_jax(rng):
    jm = jregistry.lookup("swinir")(**SWINIR)
    tm = registry.lookup("swinir")(**SWINIR)
    tm.load_state_dict(from_jax.swinir_state_dict(_np(jm.params)))
    x = rng.random((2, 7, 9, 3)).astype(np.float32)
    ref = _check(jm, tm.eval().freeze(), x)
    # the reflect pad to 8 x 12 and the padded map returned, as the
    # reference's check_image_size + 'none' path
    assert ref.shape == (2, 8, 12, 8)
    # the training form without a generator, and with one at rate 0, is
    # the eval form
    tm.drop_path_rate = 0.0
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=True, generator=gen).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("no_upsampling,scale", [(True, 2), (False, 2),
                                                 (False, 3), (False, 4)])
def test_full_edsr_matches_jax(rng, no_upsampling, scale):
    """The registered ``edsr`` (res_scale 0.1) at 2 x 16, whose trunk runs
    K3's twin on the CPU, with and without the pixel-shuffle upsampler."""
    spec = {"name": "edsr", "args": {"n_resblocks": 2, "n_feats": 16,
                                     "scale": scale,
                                     "no_upsampling": no_upsampling}}
    jm, tm = _pair(spec, from_jax.edsr_state_dict)
    assert tm.k3 and tm.res_scale == 0.1
    ref = _check(jm, tm, rng.random((1, 5, 6, 3)).astype(np.float32))
    s = 1 if no_upsampling else scale
    assert ref.shape == (1, 5 * s, 6 * s, 16 if no_upsampling else 3)


def test_full_width_edsr_convs_run_plain(rng):
    """At 256 channels (past K3's Cout) every conv is ``fnn.conv2d``: the
    kernel path is the twin path, and ``freeze()`` lays out nothing."""
    m = registry.make({"name": "edsr", "args": {"n_resblocks": 1,
                                                "no_upsampling": True}})
    m.freeze()
    assert not m.k3 and m.head[0].kweight is None and m.out_dim == 256
    x = torch.from_numpy(rng.random((1, 4, 5, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(m(x), m(x, kernels=False), rtol=0, atol=0)


def test_mlp_matches_jax(rng):
    spec = {"name": "mlp", "args": {"in_dim": 5, "out_dim": 3,
                                    "hidden_list": [7, 6]}}
    jm, tm = _pair(spec, from_jax.mlp_state_dict)
    x = rng.random((2, 4, 5)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.apply(jm.params, jnp.asarray(x))), atol=1e-6)
    assert got.shape == (2, 4, 3)
    # the JAX bridge reads the port's keys back
    ref = cv.convert_mlp(tm.state_dict())
    for a, b in zip(ref["layers"], jm.params["layers"]):
        np.testing.assert_array_equal(np.asarray(a["w"]), np.asarray(b["w"]))


ENCODERS = {
    "rrdb": {"nf": 8, "nb": 2, "gc": 4, "no_upsampling": True},
    "rdn": {"G0": 8, "RDNconfig": "A", "no_upsampling": True},
    "swinir": {"no_upsampling": True},
    "edsr": {"n_resblocks": 2, "n_feats": 16, "no_upsampling": True},
    "edsr-baseline": {"n_resblocks": 2, "n_feats": 16,
                      "no_upsampling": True},
}


def _linf_spec(name):
    return {"name": "linf", "args": {
        "encoder_spec": {"name": name, "args": ENCODERS[name]},
        "imnet_spec": {"name": "flow", "args": {"name": "flow"}},
        "flow_layers": 2, "num_layer": 2, "hidden_dim": 16}}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_linf_weights_round_trip_through_the_jax_bridge(name):
    """A port LINF's state_dict -> ``convert_linf`` (the JAX bridge) ->
    ``linf_state_dict``: the same tensors under the same keys, for each
    encoder."""
    m = registry.make(_linf_spec(name))
    m.reset_parameters(torch.Generator().manual_seed(1))
    sd = m.state_dict()
    params = cv.convert_linf(sd, name, ENCODERS[name], 2, 2, freeze=False)
    back = from_jax.linf_state_dict(_np(params), name)
    assert set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)
    # and the port's LINF loads it as the JAX model's params
    registry.make(_linf_spec(name)).load_state_dict(back)


def test_an_unknown_encoder_is_refused():
    with pytest.raises(NotImplementedError, match="rrdb"):
        from_jax.linf_state_dict({}, "vgg")


def test_linf_on_an_rrdb_encoder_matches_the_jax_predictor(rng):
    """``LINFPredictor.predict`` with the prior on a tiny RRDB-encoder
    LINF (path A's shape) against the JAX predictor: the features, the
    encoded latent and the image, within the pipeline's tolerances."""
    linf_spec, unet_spec = rrdb_linf_specs(tiny=True)
    jm = jregistry.make(linf_spec)
    jm.params["imnet"]["w"] = jm.params["imnet"]["w"] + jnp.eye(3)[None]
    jm = jm.freeze()
    jprior = jregistry.make(unet_spec)
    tm = from_jax.load_linf(registry.make(linf_spec), _np(jm.params))
    tprior = from_jax.load_prior(registry.make(unet_spec), _np(jprior.params))
    h, w, H, W = 5, 6, 10, 13
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    coord = make_coord_np((H, W), flatten=False)[None]
    cell = make_cell((H, W))[None]
    gt = (rng.random((1, H, W, 3)) - 0.5).astype(np.float32)
    t = torch.from_numpy

    jfeat = np.asarray(jm.gen_feat(jm.params, jnp.asarray(inp)))
    np.testing.assert_allclose(tm.gen_feat(t(inp)).numpy(), jfeat,
                               atol=PIPE["feat"], rtol=0)
    _, jz = jm.query_log_p(jm.params, jnp.asarray(inp), jnp.asarray(jfeat),
                           jnp.asarray(coord), jnp.asarray(cell),
                           jnp.asarray(gt))
    _, z = tm.query_log_p(t(inp), tm.gen_feat(t(inp)), t(coord), t(cell),
                          t(gt))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=PIPE["z"])
    ref = JPredictor(jm, jprior, tile_queries=64, use_pallas=False).predict(
        jm.params, jprior.params, jnp.asarray(inp), jnp.asarray(coord),
        jnp.asarray(cell), jnp.asarray(gt))
    for kernels in (True, False):
        got = LINFPredictor(tm, tprior, kernels=kernels).predict(
            t(inp), t(coord), t(cell), t(gt))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=PIPE["image"])
