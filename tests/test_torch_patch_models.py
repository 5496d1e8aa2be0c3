"""Port parity of the patch model (ps = 3, d = 27): Flow(patch_size=3),
LINFPatch against the JAX LINFPatch on the same weights (features, info,
query_log_p, the folded query_rgb), the fold order, the weight bridge, and
the UNet prior at in_chans 27 on both of its forward paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.convert.torch_import import convert_linf
from bfsr_tpu.models.linf import linf_affine_info
from bfsr_tpu.models.unet import init_unet, unet_apply
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_unet
from bfsr_tpu_torch.entry import patch_specs
from bfsr_tpu_torch.models.flow_linf import Flow
from bfsr_tpu_torch.models.linf import LINFPatch

from test_torch_models import _assert_tree_equal, _np_tree
from test_torch_patch_info import patch_port_of, small_linf_patch


def _inputs(rng, h, w, Hq, Wq, d=27):
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    coord = make_coord_np((Hq, Wq), flatten=False)[None]
    cell = make_cell((3 * Hq, 3 * Wq))[None]
    gt = (rng.random((1, Hq, Wq, d)) - 0.5).astype(np.float32)
    return inp, coord, cell, gt


def test_flow_patch_size_keys_and_init():
    f = Flow(flow_layers=4, patch_size=3)
    assert f.dim == 27 and f.spec()["args"]["patch_size"] == 3
    sd = f.state_dict()
    assert set(sd) == ({f"linears.{i}.{k}" for i in range(4)
                        for k in ("_weight", "bias")}
                       | {"last._weight", "last.bias"})
    assert sd["linears.0._weight"].shape == (27, 27)
    w = torch.stack([sd[f"linears.{i}._weight"] for i in range(4)]
                    + [sd["last._weight"]])
    assert float(w.abs().max()) <= 1 / np.sqrt(8)
    assert float(w.std()) > 0.15  # U(+-1/sqrt(8)) has std 0.204
    assert all(float(sd[k].abs().max()) == 0 for k in sd if k.endswith("bias"))
    f.freeze()
    np.testing.assert_allclose(
        (f.w_inv.double() @ f.w.double()).numpy(),
        np.broadcast_to(np.eye(27), (5, 27, 27)), atol=1e-4)
    assert f.w_inv.dtype == torch.float32


def test_linf_patch_matches_jax(rng):
    jm = small_linf_patch()
    tm = patch_port_of(jm)
    assert isinstance(tm, LINFPatch) and tm.dim == 27
    p = jm.params
    inp, coord, cell, gt = _inputs(rng, 5, 6, 10, 12)
    t = torch.from_numpy
    jfeat = jm.gen_feat(p, jnp.asarray(inp))
    feat = tm.gen_feat(t(inp))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=2e-5)

    # info: the general 2-D-gather form equals the port's grid form
    jinfo = np.asarray(linf_affine_info(p, jfeat, jnp.asarray(coord),
                                        jnp.asarray(cell), jm.hidden_dim))
    info = tm.affine_info_grid(feat, t(coord[0, :, 0, 0].copy()),
                               t(coord[0, 0, :, 1].copy()), t(cell))
    np.testing.assert_allclose(info.T.reshape(jinfo.shape).numpy(), jinfo,
                               atol=2e-4, rtol=1e-4)

    jlog_p, jz = jm.query_log_p(p, jnp.asarray(inp), jfeat, jnp.asarray(coord),
                                jnp.asarray(cell), jnp.asarray(gt))
    log_p, z = tm.query_log_p(t(inp), feat, t(coord), t(cell), t(gt))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=5e-4)
    np.testing.assert_allclose(log_p.numpy(), np.asarray(jlog_p), atol=1e-3,
                               rtol=1e-5)

    jrgb = np.asarray(jm.query_rgb(p, jnp.asarray(inp), jfeat,
                                   jnp.asarray(coord), jnp.asarray(cell),
                                   zmap=jz))
    rgb = tm.query_rgb(t(inp), feat, t(coord), t(cell), zmap=z)
    assert rgb.shape == (1, 30, 36, 3)
    np.testing.assert_allclose(rgb.numpy(), jrgb, atol=1e-3)
    # z -> residual -> z is the identity up to f32 roundoff
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jm._fold(
        jnp.asarray(gt))), atol=1e-3)


def test_fold_is_the_jax_fold(rng):
    jm = small_linf_patch()
    tm = patch_port_of(jm)
    x = rng.standard_normal((1, 4, 5, 27)).astype(np.float32)
    got = tm.fold(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm._fold(jnp.asarray(x))))
    # (c, ky, kx): channel c * 9 + ky * 3 + kx of query (i, j) lands at
    # pixel (3i + ky, 3j + kx), colour c
    assert got[0, 3 * 2 + 1, 3 * 4 + 2, 1] == x[0, 2, 4, 9 + 3 + 2]


def test_linf_patch_weight_bridge_round_trip():
    jm = small_linf_patch()
    tm = patch_port_of(jm)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sd["imnet.last._weight"].shape == (27, 27)
    assert sd["layers.4.weight"].shape == (162, 32, 1, 1)
    back = convert_linf(sd, "edsr-baseline", {"n_resblocks": 2},
                        flow_layers=3, num_layer=2, freeze=True)
    _assert_tree_equal(back, jm.params)
    np.testing.assert_allclose(tm.imnet.w_inv.numpy(),
                               np.asarray(jm.params["imnet"]["w_inv"]),
                               atol=1e-6)


def _unet27_params(rng, depth, dim):
    """JAX UNet params at in_chans 27 with non-trivial BN statistics."""
    p = _np_tree(init_unet(jax.random.PRNGKey(2), 27, depth=depth, dim=dim))

    def perturb(node):
        if isinstance(node, dict) and set(node) == {"scale", "bias", "mean",
                                                    "var"}:
            n = node["scale"].shape[0]
            node["scale"] = (rng.random(n) + 0.5).astype(np.float32)
            node["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            node["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            node["var"] = (rng.random(n) + 0.5).astype(np.float32)
        elif isinstance(node, dict):
            for v in node.values():
                perturb(v)
        elif isinstance(node, list):
            for v in node:
                perturb(v)

    perturb(p)
    return p


@pytest.mark.parametrize("hw,lr_hw", [((10, 12), (5, 6)), ((9, 13), (4, 5))])
def test_unet_in_chans_27_matches_jax(rng, hw, lr_hw):
    depth, dim = 2, 16
    params = _unet27_params(rng, depth, dim)
    prior = load_unet(registry.make({"name": "unet", "args": {
        "in_chans": 27, "depth": depth, "dim": dim}}), params).eval()
    assert prior.lr_proj[0].weight.shape == (27, 3, 3, 3)
    assert prior.input_proj.conv5.weight.shape == (8, 27 + 4 * 8, 3, 3)
    z = rng.standard_normal((1, *hw, 27)).astype(np.float32)
    lr = rng.random((1, *lr_hw, 3)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(unet_apply(jp, jnp.asarray(z), jnp.asarray(lr), depth))
    with torch.no_grad():
        plain = prior(torch.from_numpy(z), torch.from_numpy(lr),
                      kernels=False).numpy()
        fused = prior(torch.from_numpy(z), torch.from_numpy(lr),
                      kernels=True).numpy()
    assert plain.shape == (1, *hw, 27)
    np.testing.assert_allclose(plain, ref, atol=3e-5)
    np.testing.assert_allclose(fused, ref, atol=3e-5)


def test_registry_has_the_patch_model():
    assert "linf-patch" in registry.names()
    linf_spec, unet_spec = patch_specs()
    m = registry.make(linf_spec)
    assert isinstance(m, LINFPatch)
    assert m.spec() == linf_spec
    assert m.imnet.dim == 27 and m.mlp()[0][0].shape == (256, 1024)
    assert unet_spec["args"] == {"in_chans": 27, "depth": 3, "dim": 64,
                                 "bilinear": True}
