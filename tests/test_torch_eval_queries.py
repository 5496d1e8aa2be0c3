"""Validation at each query's own coordinate: ``LINFPredictor.predict``
and ``eval_psnr`` on batches that are not a grid (the
trainer's val wrapper, ``sr-implicit-downsampled-fast`` with
``inp_size``) against a JAX computation built from the JAX package's
module functions (``linf_affine_info``, ``pointwise_flow.forward`` /
``inverse``, the UNet prior, ``grid_sample_bilinear``), and the JAX
``eval_psnr``'s different answer there (it reads a batch's grid axes off
row 0 and column 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.models.linf import linf_affine_info as j_affine_info
from bfsr_tpu.ops import pointwise_flow as pwf
from bfsr_tpu.ops.interp import grid_sample_bilinear as j_grid_sample
from bfsr_tpu.pipelines.linf_eval import eval_psnr as j_eval_psnr
from bfsr_tpu_torch.data import wrappers as tw
from bfsr_tpu_torch.data.loader import stack
from bfsr_tpu_torch.pipelines.linf_eval import (LINFPredictor, eval_psnr,
                                                is_grid)
from bfsr_tpu_torch.utils import metrics

from test_torch_eval import NORM, _pixel_models

IMAGE_TOL = 1e-3  # docs/PARITY.md: the LINF pipeline's image


def _val_batches(rng, n_batches=2, batch=3, inp_size=8, wrapper=None):
    """Batches of the val wrapper over random HR images, drawn in order
    from ``random`` / ``np.random`` seeded 0."""
    imgs = [rng.random((44, 40, 3)).astype(np.float32) for _ in range(4)]
    data = (wrapper or tw.SRImplicitDownsampledFast)(
        imgs, inp_size=inp_size, scale_min=1, scale_max=4)
    random.seed(0)
    np.random.seed(0)
    items = [data[i % len(data)] for i in range(n_batches * batch)]
    return [stack(items[i:i + batch]) for i in range(0, len(items), batch)]


def _norm(batch):
    return (batch["inp"] - 0.5) / 0.5


def jax_queries(jm, jprior, inp, coord, cell, gt_lr_up=None):
    """The reference's prediction at each query's own coordinate, from the
    JAX package's module functions."""
    inp, coord, cell = (jnp.asarray(a) for a in (inp, coord, cell))
    B, h, w, _ = coord.shape
    n = B * h * w
    feat = jm.gen_feat(jm.params, inp)
    info = j_affine_info(jm.params, feat, coord, cell,
                         jm.hidden_dim).reshape(n, -1)
    if gt_lr_up is None:
        z = jnp.zeros((n, 3), jnp.float32)
    else:
        z, _ = pwf.forward(jm.params["imnet"],
                           jnp.asarray(gt_lr_up).reshape(n, 3), info)
        z = jprior.apply(jprior.params, z.reshape(B, h, w, 3), inp)
    res = pwf.inverse(jm.params["imnet"], z.reshape(n, 3), info)
    return np.asarray(res.reshape(B, h, w, 3)
                      + j_grid_sample(inp, coord, padding_mode="border"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("with_prior", [True, False])
def test_predict_queries_matches_the_jax_module_functions(rng, with_prior):
    jm, jprior, tm, tprior = _pixel_models()
    if not with_prior:
        jprior = tprior = None
    for b in _val_batches(rng):
        assert not is_grid(_t(b["coord"]))
        gt_lr_up = b["gt_lr_up"] if with_prior else None
        ref = jax_queries(jm, jprior, _norm(b), b["coord"], b["cell"],
                          gt_lr_up)
        for kernels in (True, False):
            got = LINFPredictor(tm, tprior, kernels=kernels).predict(
                _t(_norm(b)), _t(b["coord"]), _t(b["cell"]),
                None if gt_lr_up is None else _t(gt_lr_up))
            assert got.shape == ref.shape == (3, 8, 8, 3)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=IMAGE_TOL)


def test_predict_queries_on_a_grid_is_the_grid_predict(rng):
    """A batch of two copies of one grid sample goes query by query; each
    copy is the one sample's grid predict (K2's info)."""
    _, _, tm, tprior = _pixel_models()
    img = rng.random((24, 30, 3)).astype(np.float32)
    b = stack([tw.SRImplicitDownsampledFast([img], scale_min=3)[0]])
    args = (_t(_norm(b)), _t(b["coord"]), _t(b["cell"]), _t(b["gt_lr_up"]))
    assert is_grid(args[1])
    two = [torch.cat([a, a]) for a in args]
    pred = LINFPredictor(tm, tprior)
    one = pred.predict(*args)
    for got in pred.predict(*two):
        torch.testing.assert_close(got[None], one, rtol=0, atol=1e-5)
    z = torch.randn((1, 24, 30, 3), generator=torch.Generator().manual_seed(1))
    pred = LINFPredictor(tm, None)
    one = pred.predict(*args[:3], z=z)
    for got in pred.predict(*two[:3], z=torch.cat([z, z])):
        torch.testing.assert_close(got[None], one, rtol=0, atol=1e-5)


def test_predict_queries_refuses_a_patch_model():
    """A patch model predicts its patch-centre grid, one image a batch."""
    from test_torch_eval import _patch_models

    _, _, tm, tprior = _patch_models()
    coord = torch.zeros((2, 3, 3, 2))
    with pytest.raises(ValueError, match="patch-centre grid, batch 1"):
        LINFPredictor(tm, tprior).predict(
            torch.zeros((2, 4, 4, 3)), coord, torch.ones((2, 2)))


def _psnr_of(preds, batches):
    """eval_psnr's mean: one PSNR a batch over all its samples."""
    vals = [metrics.calc_psnr(
        np.transpose(np.clip(p * 0.5 + 0.5, 0, 1), (0, 3, 1, 2)),
        np.transpose(b["gt"], (0, 3, 1, 2))) for p, b in zip(preds, batches)]
    return sum(vals) / len(vals)


def test_validation_psnr_is_taken_at_each_querys_coordinate(rng):
    """The port's validation PSNR is that of the reference's predictions
    at the queries of ``gt``; the JAX ``eval_psnr`` predicts the grid of
    each sample's row 0 and column 0 instead, and reads another PSNR."""
    jm, jprior, tm, tprior = _pixel_models()
    batches = _val_batches(rng)
    want = _psnr_of([jax_queries(jm, jprior, _norm(b), b["coord"], b["cell"],
                                 b["gt_lr_up"]) for b in batches], batches)
    got = eval_psnr(batches, tm, tprior, data_norm=NORM)
    assert got == pytest.approx(want, abs=0.01)
    assert eval_psnr(batches, tm, tprior, data_norm=NORM,
                     kernels=False) == pytest.approx(got, abs=1e-6)
    jax_psnr = j_eval_psnr(batches, jm, jprior, data_norm=NORM,
                           log_fn=lambda *_: None)
    assert abs(jax_psnr - got) > 0.1, (jax_psnr, got)
    # the JAX predictor's answer is the reference's at the grid it reads
    b = batches[0]
    cy, cx = b["coord"][:, :, :1, :1], b["coord"][:, :1, :, 1:]
    grid = np.concatenate(np.broadcast_arrays(cy, cx), -1)
    ref = jax_queries(jm, jprior, _norm(b), grid, b["cell"], b["gt_lr_up"])
    got_grid = LINFPredictor(tm, tprior).predict(
        _t(_norm(b)), _t(grid), _t(b["cell"]), _t(b["gt_lr_up"]))
    np.testing.assert_allclose(got_grid.numpy(), ref, atol=IMAGE_TOL)
    assert _psnr_of([got_grid.numpy()], [b]) != pytest.approx(
        _psnr_of([jax_queries(jm, jprior, _norm(b), b["coord"], b["cell"],
                              b["gt_lr_up"])], [b]), abs=0.1)


def test_eval_psnr_batches_of_grids_go_query_by_query(rng):
    """B > 1 on grids: one PSNR a batch, equal to the grid predicts'."""
    _, _, tm, tprior = _pixel_models()
    imgs = [rng.random((24, 30, 3)).astype(np.float32) for _ in range(4)]
    items = [tw.SRImplicitDownsampledFast([im], scale_min=3)[0]
             for im in imgs]
    batches = [stack(items[:2]), stack(items[2:])]
    got = eval_psnr(batches, tm, tprior, data_norm=NORM)
    pred = LINFPredictor(tm, tprior)
    preds = [np.concatenate([pred.predict(
        _t(_norm(stack([it]))), _t(it["coord"][None]), _t(it["cell"][None]),
        _t(it["gt_lr_up"][None])).numpy() for it in pair])
        for pair in (items[:2], items[2:])]
    assert got == pytest.approx(_psnr_of(preds, batches), abs=1e-3)
