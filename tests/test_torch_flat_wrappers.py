"""Port parity of the four flat LIIF-style wrappers: ``sr-implicit-paired``,
``sr-implicit-downsampled``, ``sr-implicit-downsampled-fast-patch`` and
``sr-implicit-uniform-varied``, each against the JAX wrapper of the same
name on the same data and the same ``random`` / ``np.random`` seeds, draw
for draw: the same items, and the generators left in the same state after
them.

Tolerance: exact for what only moves or resizes pixels (crops, flips,
coords, cells, PIL resizes, the query subsets); 3e-6 for the residual
patches (``gt_patch``, ``gt_lr_up``), which the JAX package may compute
with its native C++ resize (``tests/test_torch_eval_data.py``).
"""

import random

import numpy as np
import pytest

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.data.wrappers  # noqa: F401  (registers)
from bfsr_tpu import registry as jregistry
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.data import wrappers  # noqa: F401  (registers)

pytest.importorskip("PIL.Image")

NAMES = ("sr-implicit-paired", "sr-implicit-downsampled",
         "sr-implicit-downsampled-fast-patch", "sr-implicit-uniform-varied")


def _items(wrapper, n, seed):
    """``n`` items in order after seeding ``random`` and ``np.random`` with
    ``seed``, and a draw from each generator after them."""
    random.seed(seed)
    np.random.seed(seed)
    items = [wrapper[i % len(wrapper)] for i in range(n)]
    return items, (random.random(), np.random.random())


def _check(name, data, kw, n=5, seed=0):
    got, got_next = _items(registry.make(
        {"name": name, "args": {"dataset": data, **kw}}), n, seed)
    ref, ref_next = _items(jregistry.make(
        {"name": name, "args": {"dataset": data, **kw}}), n, seed)
    assert got_next == ref_next
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].shape == r[k].shape, k
            assert g[k].dtype == r[k].dtype, k
            atol = 3e-6 if k in ("gt_patch", "gt_lr_up") else 0
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=atol,
                                       err_msg=k)
    return got


def _pairs(rng, shapes=((10, 12), (9, 8), (8, 11)), s=4):
    return [(rng.random((h, w, 3)).astype(np.float32),
             rng.random((h * s + 2, w * s + 1, 3)).astype(np.float32))
            for h, w in shapes]


def _hr_images(rng, shapes=((40, 52), (45, 37), (36, 36))):
    return [rng.random((*s, 3)).astype(np.float32) for s in shapes]


def test_every_jax_sr_implicit_wrapper_is_registered():
    """With these four, the port has each of the JAX package's ten
    ``sr-implicit-*`` wrappers."""
    want = {k for k in jregistry.names() if k.startswith("sr-implicit")}
    assert set(NAMES) <= want
    assert want <= set(registry.names())


@pytest.mark.parametrize("kw", [
    {},
    {"augment": True},
    {"inp_size": 6, "augment": True},
    {"sample_q": 50},
    {"inp_size": 5, "augment": True, "sample_q": 40},
])
def test_paired_matches_jax(rng, kw):
    items = _check("sr-implicit-paired", _pairs(rng), kw)
    if "sample_q" in kw:
        assert items[0]["coord"].shape == (kw["sample_q"], 2)


@pytest.mark.parametrize("kw", [
    {"scale_min": 4},
    {"scale_min": 2, "scale_max": 4, "augment": True, "sample_q": 30},
    {"inp_size": 8, "scale_max": 4, "sample_q": 64},
    {"inp_size": 7, "scale_min": 2, "scale_max": 3, "augment": True},
])
def test_downsampled_matches_jax(rng, kw):
    _check("sr-implicit-downsampled", _hr_images(rng), kw)


@pytest.mark.parametrize("kw", [
    {"scale_min": 3},
    {"scale_min": 2, "scale_max": 4, "augment": True},
    {"inp_size": 8, "scale_min": 2, "scale_max": 4, "augment": True},
    {"inp_size": 6, "scale_max": 3, "patch_size": 5},
])
def test_downsampled_fast_patch_matches_jax(rng, kw):
    """The stride-1 patches of both residuals and, with ``inp_size``, the
    random query subset (not a window: ROADMAP queue 3)."""
    items = _check("sr-implicit-downsampled-fast-patch", _hr_images(rng), kw)
    ps = kw.get("patch_size", 3)
    assert items[0]["gt_patch"].shape[-1] == 3 * ps * ps
    if "inp_size" in kw:
        assert items[0]["coord"].shape == (kw["inp_size"], kw["inp_size"], 2)


@pytest.mark.parametrize("kw", [
    {"size_min": 24, "size_max": 40},
    {"size_min": 20, "size_max": 36, "augment": True, "sample_q": 60},
    {"size_min": 32, "augment": True, "gt_resize": 28},
])
def test_uniform_varied_matches_jax(rng, kw):
    items = _check("sr-implicit-uniform-varied", _pairs(rng), kw, n=3)
    if "sample_q" not in kw and "gt_resize" not in kw:
        # the HR side grows with the index: 24, 32, 40 on the shorter side
        sides = [int(np.sqrt(len(it["coord"]))) for it in items]
        assert sides[0] < sides[1] < sides[2]
