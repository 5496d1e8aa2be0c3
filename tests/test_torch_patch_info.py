"""Port parity at the patch model's wide info: the K2 twin at out_dim
2dL = 162 (d = 27, L = 3) against the JAX fused affine-info kernel
(interpret mode) and linf_affine_info_grid, and the packed MLP K2 reads
at out_dim > 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.models.linf import linf_affine_info_grid as j_info_grid
from bfsr_tpu.ops import nn as jnn
from bfsr_tpu.ops.pallas.linf_info import fused_affine_info_cm
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_linf
from bfsr_tpu_torch.entry import patch_specs
from bfsr_tpu_torch.ops.cuda import linf_info as tli


def small_linf_patch():
    """tests/test_pallas_predictor.py's patch model: EDSR 2 x 16, L = 3,
    hidden 32, ps = 3, flow weights w * 0.05 + I, frozen."""
    m = jregistry.make({"name": "linf-patch", "args": {
        "encoder_spec": {"name": "edsr-baseline",
                         "args": {"n_resblocks": 2, "n_feats": 16,
                                  "no_upsampling": True}},
        "imnet_spec": {"name": "flow", "args": {"name": "flow"}},
        "flow_layers": 3, "num_layer": 2, "hidden_dim": 32,
        "patch_size": 3}})
    m.params["imnet"]["w"] = m.params["imnet"]["w"] * 0.05 + jnp.eye(27)[None]
    return m.freeze()


def patch_port_of(jm):
    """The port's LINFPatch holding ``jm``'s weights, frozen."""
    m = registry.make(patch_specs(tiny=True)[0])
    return load_linf(m, jax.tree_util.tree_map(np.asarray, jm.params))


def test_k2_twin_at_out_dim_162_matches_jax(rng):
    h, w, Hq, Wq = 6, 7, 8, 128  # the Pallas kernel's tile quanta: 8 x 128
    jm = small_linf_patch()
    tm = patch_port_of(jm)
    p = jm.params
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    feat = np.array(jm.gen_feat(p, jnp.asarray(inp)))
    coord = make_coord_np((Hq, Wq), flatten=False)
    cy, cx = coord[:, 0, 0], coord[0, :, 1]
    cell = make_cell((3 * Hq, 3 * Wq))
    jfeat = jnp.asarray(feat)
    ref = np.asarray(j_info_grid(p, jfeat, jnp.asarray(cy)[None],
                                 jnp.asarray(cx)[None],
                                 jnp.asarray(cell)[None], jm.hidden_dim))[0]
    out_dim = ref.shape[-1]
    assert out_dim == 162
    coef = jnn.conv2d(jfeat, p["coef"])
    freq = jnn.conv2d(jfeat, p["freq"])
    pal = np.asarray(fused_affine_info_cm(
        p, coef, freq, jnp.asarray(cy), jnp.asarray(cx),
        jnp.asarray(cell)[None], jm.hidden_dim, interpret=True))
    pal = pal[:out_dim].T.reshape(Hq, Wq, out_dim)

    got = tm.affine_info_grid(torch.from_numpy(feat), torch.from_numpy(cy),
                              torch.from_numpy(cx),
                              torch.from_numpy(cell)[None], kernels=False)
    assert got.shape == (out_dim, Hq * Wq)
    got = got.T.reshape(Hq, Wq, out_dim).numpy()
    np.testing.assert_allclose(got, pal, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    # the wrapper runs the same twin for a CPU tensor at any out_dim
    torch.testing.assert_close(
        tm.affine_info_grid(torch.from_numpy(feat), torch.from_numpy(cy),
                            torch.from_numpy(cx),
                            torch.from_numpy(cell)[None]).T.reshape(
                                Hq, Wq, out_dim),
        torch.from_numpy(got), rtol=0, atol=0)


@pytest.mark.parametrize("C,out_dim", [(8, 540), (16, 129)])
def test_pack_mlp_at_wide_out_dim(rng, C, out_dim):
    """The last layer's (in, out) block and bias at the offsets
    linf_info.cu reads, for an out_dim past one 128-column pass."""
    dims = [4 * C, C, C, out_dim]
    mlp = [(torch.from_numpy(rng.standard_normal((o, i)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(o).astype(np.float32)))
           for i, o in zip(dims[:-1], dims[1:])]
    buf = tli.pack_mlp(mlp)
    w4 = 4 * C * C + C + (C * C + C)
    last = buf[w4:w4 + C * out_dim].reshape(C, out_dim)
    torch.testing.assert_close(last, mlp[-1][0].T, rtol=0, atol=0)
    torch.testing.assert_close(buf[w4 + C * out_dim:], mlp[-1][1], rtol=0,
                               atol=0)
    # each 128-column pass is a contiguous column block of rows of out_dim
    for c0 in range(0, out_dim, 128):
        torch.testing.assert_close(last[:, c0:c0 + 128],
                                   mlp[-1][0][c0:c0 + 128].T, rtol=0, atol=0)


def test_wrapper_limits_name_the_kernel():
    assert tli.KERNEL_MAX_OUT == 1024
    assert tli.KERNEL_HIDDEN == (128, 256)
    m = registry.make(patch_specs()[0])
    assert m.mlp()[-1][0].shape == (540, 256)
    assert m.mlp()[-1][0].shape[0] <= tli.KERNEL_MAX_OUT
