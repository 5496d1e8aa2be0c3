"""Port parity: the whole LINF-LP patch predict (ps = 3, d = 27) against
the JAX LINFPredictor on its Pallas path (interpret mode) and its jnp
path, on a regular patch-centre grid and on a padded ragged one, and the
patch path's import hygiene (no jax)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.data.wrappers import _center_coords
from bfsr_tpu.pipelines.linf_eval import LINFPredictor as JPredictor
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_unet
from bfsr_tpu_torch.entry import build_linf_patch, patch_specs
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

from test_torch_patch_info import patch_port_of, small_linf_patch


def _models():
    jm = small_linf_patch()
    jprior = jregistry.make({"name": "unet", "args": {"in_chans": 27,
                                                      "depth": 2, "dim": 16}})
    tprior = load_unet(registry.make(patch_specs(tiny=True)[1]),
                       jax.tree_util.tree_map(np.asarray, jprior.params))
    return jm, jprior, patch_port_of(jm), tprior.eval()


def _grid(rng, h, w, hr_hw, ragged):
    """(inp, coord, cell, gt) on the patch-centre grid of an HR image:
    regular (ps divides the HR size) or the padded grid the patch wrapper
    queries (a centre that falls in the padding gets zero coords)."""
    H, W = hr_hw
    if ragged:
        pad_h, pad_w = 3 - H % 3, 3 - W % 3
        coord = _center_coords(make_coord_np((H, W), flatten=False), 3,
                               pad_h, pad_w)[None]
    else:
        coord = make_coord_np((H // 3, W // 3), flatten=False)[None]
    Hq, Wq = coord.shape[1:3]
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    gt = (rng.random((1, Hq, Wq, 27)) - 0.5).astype(np.float32)
    return inp, coord, make_cell((H, W))[None], gt


@pytest.mark.parametrize("use_pallas,ragged", [(True, False), (False, False),
                                               (False, True)])
def test_patch_prior_path_matches_jax(rng, use_pallas, ragged):
    jm, jprior, tm, tprior = _models()
    inp, coord, cell, gt = _grid(rng, 5, 6, (16, 19) if ragged else (30, 36),
                                 ragged)
    if ragged:  # a padded centre row and column, both at coord 0
        assert coord.shape[1:3] == (6, 7)
        assert coord[0, -1, 0, 0] == 0 and coord[0, 0, -1, 1] == 0
    ref = JPredictor(jm, jprior, tile_queries=32, use_pallas=use_pallas).predict(
        jm.params, jprior.params, jnp.asarray(inp), jnp.asarray(coord),
        jnp.asarray(cell), jnp.asarray(gt))
    t = torch.from_numpy
    for kernels in (True, False):
        got = LINFPredictor(tm, tprior, kernels=kernels).predict(
            t(inp), t(coord), t(cell), t(gt))
        assert got.shape == (1, 3 * coord.shape[1], 3 * coord.shape[2], 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


def test_patch_zero_temperature_matches_jax(rng):
    jm, _, tm, _ = _models()
    inp, coord, cell, _ = _grid(rng, 4, 4, (24, 27), False)
    ref = JPredictor(jm, None, tile_queries=24, use_pallas=False).predict(
        jm.params, None, jnp.asarray(inp), jnp.asarray(coord),
        jnp.asarray(cell))
    t = torch.from_numpy
    got = LINFPredictor(tm).predict(t(inp), t(coord), t(cell))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


def test_build_linf_patch_tiny_on_cpu():
    model, prior = build_linf_patch("cpu", seed=1, tiny=True)
    assert model.dim == 27 and prior.in_chans == 27
    # w * 0.05 + I: well-conditioned
    assert float((model.imnet.w - torch.eye(27)).abs().max()) <= 0.05 / 8 ** 0.5
    other, _ = build_linf_patch("cpu", seed=2, tiny=True)
    assert not torch.equal(model.coef.weight, other.coef.weight)
    with pytest.raises(ValueError):
        build_linf_patch("cuda", tiny=True)


def test_patch_path_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from bfsr_tpu_torch.entry import build_linf_patch, "
        "example_patch_inputs\n"
        "from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor, "
        "eval_psnr\n"
        "import bfsr_tpu_torch.data.wrappers, bfsr_tpu_torch.utils.metrics\n"
        "m, p = build_linf_patch('cpu', tiny=True)\n"
        "out = LINFPredictor(m, p).predict(*example_patch_inputs("
        "'cpu', (4, 5), (8, 10)))\n"
        "assert out.shape == (1, 24, 30, 3) and torch.isfinite(out).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bfsr_tpu' or m.startswith('bfsr_tpu.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
