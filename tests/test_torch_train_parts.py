"""Port parity for the LINF-LP trainer's parts, on the CPU (the twins),
against the JAX package: the batched K2 twin and the general 2-D-gather
affine info, the batched grid samples, the training UNet and its
running-stat update, the VGG features, the losses, Adam with its LR
schedules, and the gradient of the flow inverse."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bfsr_tpu import registry as jregistry
from bfsr_tpu.models.linf import linf_affine_info as j_info
from bfsr_tpu.models.linf import linf_affine_info_grid as j_info_grid
from bfsr_tpu.models.unet import apply_bn_updates as j_apply_bn_updates
from bfsr_tpu.models.unet import init_unet, unet_apply
from bfsr_tpu.models.vgg import init_vgg19_features, vgg19_features
from bfsr_tpu.ops import interp as jinterp
from bfsr_tpu.ops import pointwise_flow as jpwf
from bfsr_tpu.pipelines import losses as jlosses
from bfsr_tpu.train import optim as joptim
from bfsr_tpu.utils.coords import make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_linf, load_unet, load_vgg
from bfsr_tpu_torch.models.linf import grid_axes
from bfsr_tpu_torch.ops import interp as tinterp
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.pipelines import losses as tlosses
from bfsr_tpu_torch.train import optim as toptim
from bfsr_tpu_torch.utils.coords import make_cell

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)

B, LR_HW, CROP = 2, (8, 8), 8
SCALES = (1.5, 3.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def small_linf_spec():
    """EDSR 2 x 16, flow L = 2, info MLP hidden 32."""
    return {"name": "linf", "args": {
        "encoder_spec": {"name": "edsr-baseline",
                         "args": {"n_resblocks": 2, "n_feats": 16,
                                  "no_upsampling": True}},
        "imnet_spec": {"name": "flow", "args": {"name": "flow"}},
        "flow_layers": 2, "num_layer": 2, "hidden_dim": 32}}


def small_jax_linf():
    m = jregistry.make(small_linf_spec())
    m.params["imnet"]["w"] = m.params["imnet"]["w"] + jnp.eye(3)[None]
    return m.freeze()


def port_linf(jm):
    return load_linf(registry.make(small_linf_spec()), _np(jm.params))


def crops(rng):
    """Per-sample (coord (8, 8, 2), cell (2,)): an 8^2 window of the HR
    grid at each of SCALES."""
    coords, cells = [], []
    for s in SCALES:
        n = round(CROP * s)
        y0, x0 = rng.integers(0, n - CROP + 1, 2)
        coords.append(make_coord_np((n, n), flatten=False)
                      [y0:y0 + CROP, x0:x0 + CROP])
        cells.append(make_cell((n, n)))
    return np.stack(coords), np.stack(cells)


@pytest.fixture(scope="module")
def linf_pair():
    jm = small_jax_linf()
    return jm, port_linf(jm)


def test_batched_k2_twin_matches_jax_grid(linf_pair):
    jm, tm = linf_pair
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((B, *LR_HW, 16)).astype(np.float32)
    coord, cell = crops(rng)
    cy, cx = grid_axes(torch.from_numpy(coord))
    ref = np.asarray(j_info_grid(jm.params, jnp.asarray(feat),
                                 jnp.asarray(cy.numpy()),
                                 jnp.asarray(cx.numpy()), jnp.asarray(cell),
                                 jm.hidden_dim))
    got = tm.affine_info_grid(torch.from_numpy(feat), cy, cx,
                              torch.from_numpy(cell), kernels=True)
    assert got.shape == (12, B * CROP * CROP)
    np.testing.assert_allclose(got.T.reshape(ref.shape).numpy(), ref,
                               atol=2e-5, rtol=0)
    # each sample's columns are that sample's own batch-1 info
    for b in range(B):
        one = tm.affine_info_grid(torch.from_numpy(feat[b:b + 1]),
                                  cy[b], cx[b], torch.from_numpy(cell[b:b + 1]))
        torch.testing.assert_close(
            got[:, b * CROP * CROP:(b + 1) * CROP * CROP], one, rtol=0,
            atol=0)


def test_general_affine_info_matches_jax(linf_pair):
    jm, tm = linf_pair
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((B, *LR_HW, 16)).astype(np.float32)
    coord = rng.uniform(-1, 1, (B, 5, 7, 2)).astype(np.float32)
    cell = rng.uniform(0.05, 0.3, (B, 2)).astype(np.float32)
    ref = np.asarray(j_info(jm.params, jnp.asarray(feat), jnp.asarray(coord),
                            jnp.asarray(cell), jm.hidden_dim))
    got = tm.linf_affine_info(torch.from_numpy(feat), torch.from_numpy(coord),
                              torch.from_numpy(cell))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_query_log_p_general_matches_grid_on_crops(linf_pair):
    """On separable crops the 2-D-gather encode and the grid encode agree
    (the step's one-info premise)."""
    _, tm = linf_pair
    rng = np.random.default_rng(2)
    inp = torch.from_numpy(rng.random((B, *LR_HW, 3)).astype(np.float32))
    coord, cell = (torch.from_numpy(a) for a in crops(rng))
    gt = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, CROP, CROP, 3))
                          .astype(np.float32))
    feat = tm.gen_feat(inp)
    lp_g, z_g = tm.query_log_p(inp, feat, coord, cell, gt)
    lp_a, z_a = tm.query_log_p_general(inp, feat, coord, cell, gt)
    torch.testing.assert_close(z_g, z_a, rtol=0, atol=2e-5)
    torch.testing.assert_close(lp_g, lp_a, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_batched_grid_sample_matches_jax(padding_mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 6, 9, 3)).astype(np.float32)
    coord = rng.uniform(-1.2, 1.2, (B, 4, 5, 2)).astype(np.float32)
    ref = np.asarray(jinterp.grid_sample_bilinear(
        jnp.asarray(x), jnp.asarray(coord), padding_mode=padding_mode))
    got = tinterp.grid_sample_bilinear(torch.from_numpy(x),
                                       torch.from_numpy(coord), padding_mode)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_per_sample_separable_grid_sample_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, *LR_HW, 3)).astype(np.float32)
    coord, _ = crops(rng)
    ref = np.asarray(jinterp.grid_sample_bilinear(jnp.asarray(x),
                                                  jnp.asarray(coord)))
    cy, cx = grid_axes(torch.from_numpy(coord))
    got = tinterp.grid_sample_bilinear_separable(torch.from_numpy(x), cy, cx)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


BN_PATHS = {"bn1": "double_conv.1", "bn2": "double_conv.4"}


def bn_name(path):
    """The port's BatchNorm name of a JAX bn_updates path."""
    if path[0] == "inc":
        return f"inc.{BN_PATHS[path[1]]}"
    stage = ("down_layers.{}.maxpool_conv.1" if path[0] == "down"
             else "up_layers.{}.conv").format(path[1])
    return f"{stage}.{BN_PATHS[path[2]]}"


@pytest.fixture(scope="module")
def unet_pair():
    params = _np(init_unet(jax.random.PRNGKey(3), 3, depth=2, dim=8))
    prior = load_unet(registry.make({"name": "unet", "args": {
        "in_chans": 3, "depth": 2, "dim": 8}}), params).train()
    return params, prior


def test_training_unet_matches_jax(unet_pair):
    params, prior = unet_pair
    rng = np.random.default_rng(5)
    z = rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32)
    lr = rng.random((B, *LR_HW, 3)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref, jstats = unet_apply(jp, jnp.asarray(z), jnp.asarray(lr), depth=2,
                             training=True)
    out, stats = prior(torch.from_numpy(z), torch.from_numpy(lr),
                       training=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=5e-5)
    assert set(stats) == {bn_name(p) for p in jstats}
    for path, (mean, var) in jstats.items():
        m, v = stats[bn_name(path)]
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(mean),
                                   atol=5e-5)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(var),
                                   atol=5e-5)


def test_apply_bn_updates_matches_jax(unet_pair):
    params, _ = unet_pair
    prior = load_unet(registry.make({"name": "unet", "args": {
        "in_chans": 3, "depth": 2, "dim": 8}}), params)
    rng = np.random.default_rng(6)
    jstats, stats = {}, {}
    for path in (("inc", "bn1"), ("down", 0, "bn2"), ("up", 1, "bn1")):
        n = prior.get_submodule(bn_name(path)).num_features
        mean = rng.standard_normal(n).astype(np.float32)
        var = rng.random(n).astype(np.float32) + 0.5
        jstats[path] = (jnp.asarray(mean), jnp.asarray(var))
        stats[bn_name(path)] = (torch.from_numpy(mean), torch.from_numpy(var))
    ref = j_apply_bn_updates(jax.tree_util.tree_map(jnp.asarray, params),
                             jstats)
    prior.apply_bn_updates(stats)
    for path in jstats:
        bn = prior.get_submodule(bn_name(path))
        node = ref
        for k in path:
            node = node[k]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(node["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(node["var"]), atol=1e-6)


@pytest.mark.parametrize("feature_layer,hw", [(8, (12, 10)), (34, (16, 16))])
def test_vgg_matches_jax(feature_layer, hw):
    params = _np(init_vgg19_features(jax.random.PRNGKey(feature_layer),
                                     feature_layer))
    vgg = load_vgg(registry.make({"name": "VGGFeatureExtractor", "args": {
        "feature_layer": feature_layer}}), params)
    x = np.random.default_rng(7).random((B, *hw, 3)).astype(np.float32)
    ref = np.asarray(vgg19_features(jax.tree_util.tree_map(jnp.asarray,
                                                           params),
                                    jnp.asarray(x), feature_layer))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-5 * max(1.0,
                                                         np.abs(ref).max()))


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "charbonnier_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal((B, 5, 6, 3)).astype(np.float32)
            for _ in range(2))
    ref = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tlosses, name)(torch.from_numpy(a),
                                       torch.from_numpy(b)))
    assert math.isclose(got, ref, rel_tol=1e-6)


def test_nll_bits_per_dim_matches_jax():
    obj = np.array([-1234.5, 17.25], np.float32)
    ref = np.asarray(jlosses.nll_bits_per_dim(jnp.asarray(obj), 4096))
    got = tlosses.nll_bits_per_dim(torch.from_numpy(obj), 4096).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _param_trees(rng):
    shapes = {"a": (4, 3), "b": (5,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("spec", [
    {"name": "adam", "args": {"lr": 1e-3}},
    {"name": "adam", "args": {"lr": 1e-2, "betas": (0.8, 0.99), "eps": 1e-6,
                              "weight_decay": 0.1}},
    {"name": "sgd", "args": {"lr": 1e-2, "momentum": 0.9,
                             "weight_decay": 0.01}},
])
def test_optimizer_with_multi_step_lr_matches_optax(spec):
    """Five updates on the same gradients, the LR halving at counts 2 and
    4 (torch's LambdaLR stepped once per iteration)."""
    rng = np.random.default_rng(9)
    p0 = _param_trees(rng)
    grads = [_param_trees(rng) for _ in range(5)]
    base = spec["args"]["lr"]
    jopt = joptim.make_optimizer(spec, joptim.multi_step_lr(base, [2, 4],
                                                            0.5))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = toptim.make_optimizer(spec, list(tp.values()))
    sched = toptim.lr_scheduler(topt, toptim.multi_step_lr(base, [2, 4], 0.5),
                                base)
    for g in grads:
        upd, state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k].copy())
        topt.step()
        sched.step()
        # 1e-7 absolute and relative: one f32 ulp at |p| ~ 1 is 1.2e-7
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-7,
                                       rtol=1e-7)


@pytest.mark.parametrize("make", [
    lambda m: m.multi_step_lr(1e-4, [200, 400, 600], 0.5),
    lambda m: m.multi_step_restart(2e-4, [100, 250, 300], 0.5, [250, 500],
                                   [0.5, 0.25]),
    lambda m: m.cosine_restart(2e-4, [200, 150, 300], 1e-7, [200, 350],
                               [1.0, 0.5]),
    lambda m: m.with_warmup(m.multi_step_lr(1e-4, [200], 0.5), 1e-4, 50),
], ids=["multi_step_lr", "multi_step_restart", "cosine_restart",
        "with_warmup"])
def test_schedules_match_jax(make):
    """Values at and across every milestone / restart, and between, to
    1e-6 of the value or of the base LR (JAX evaluates the cosine in
    f32)."""
    jsched, tsched = make(joptim), make(toptim)
    steps = sorted({s + d for s in (0, 25, 50, 100, 150, 200, 250, 300, 350,
                                    400, 500, 600, 700) for d in (-1, 0, 1)
                    if s + d >= 0})
    for s in steps:
        assert math.isclose(tsched(s), float(jsched(s)), rel_tol=1e-6,
                            abs_tol=1e-6 * tsched(0)), s


def test_flow_inverse_gradient_matches_jax_vjp():
    rng = np.random.default_rng(10)
    n_layers, n = 3, 200
    w = (rng.uniform(-1, 1, (n_layers + 1, 3, 3)) / np.sqrt(8)
         + np.eye(3)).astype(np.float32)
    b = (0.1 * rng.standard_normal((n_layers + 1, 3))).astype(np.float32)
    z = rng.standard_normal((n, 3)).astype(np.float32)
    info = (0.5 * rng.standard_normal((n, 6 * n_layers))).astype(np.float32)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    jp = jpwf.cache_inverses({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    x_ref, vjp = jax.vjp(lambda zz: jpwf.inverse(jp, zz, jnp.asarray(info)),
                         jnp.asarray(z))
    (gz_ref,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    x = linf_flow.flow_inverse_diff(torch.from_numpy(np.asarray(jp["w_inv"])),
                                    torch.from_numpy(b), zt,
                                    torch.from_numpy(info.T.copy()))
    x.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_ref),
                               atol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz_ref),
                               atol=1e-5 * max(1.0, np.abs(gz_ref).max()))
