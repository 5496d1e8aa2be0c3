"""Port parity of the LINF eval surface: metrics, Averager, the numpy
bilinear resize and imresize, the two paired eval wrappers, and
eval_psnr on pixel and patch models against the JAX eval_psnr on the
same in-memory pairs and weights."""

import jax
import numpy as np
import pytest

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.data import wrappers as jw
from bfsr_tpu.data.np_interp import resize_bilinear_np as j_resize
from bfsr_tpu.ops.imresize import imresize as j_imresize
from bfsr_tpu.pipelines.linf_eval import eval_psnr as j_eval_psnr
from bfsr_tpu.utils import metrics as jm_
from bfsr_tpu.utils.misc import Averager as JAverager
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_unet
from bfsr_tpu_torch.data import wrappers as tw
from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
from bfsr_tpu_torch.entry import flagship_specs, patch_specs
from bfsr_tpu_torch.ops.imresize import imresize
from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr
from bfsr_tpu_torch.utils import metrics
from bfsr_tpu_torch.utils.misc import Averager

from test_pipelines import small_linf
from test_torch_info import port_of
from test_torch_patch_info import patch_port_of, small_linf_patch

NORM = {"inp": {"sub": [0.5], "div": [0.5]}, "gt": {"sub": [0.5], "div": [0.5]}}


def _pairs(rng, n=2, lr_hw=(8, 9), s=2):
    return [(rng.random((*lr_hw, 3)).astype(np.float32),
             rng.random((lr_hw[0] * s, lr_hw[1] * s, 3)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("dataset,scale", [(None, 1), ("div2k", 2),
                                           ("benchmark", 3)])
def test_metrics_match_jax(rng, dataset, scale):
    a = rng.random((1, 3, 20, 17))
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1)
    assert metrics.calc_psnr(a, b, dataset, scale) == jm_.calc_psnr(
        a, b, dataset, scale)
    assert metrics.calc_psnr(a[0], b[0], dataset, scale) == jm_.calc_psnr(
        a[0], b[0], dataset, scale)
    x, y = a[0].transpose(1, 2, 0) * 255, b[0].transpose(1, 2, 0) * 255
    assert metrics.calculate_ssim(x, y) == jm_.calculate_ssim(x, y)
    assert metrics.calculate_ssim(x[..., 0], y[..., 0]) == \
        jm_.calculate_ssim(x[..., 0], y[..., 0])
    with pytest.raises(ValueError):
        metrics.calculate_ssim(x, y[:-1])


def test_averager_matches_jax():
    a, b = Averager(), JAverager()
    for v, n in ((3.0, 1), (5.5, 2), (-1.0, 0.5)):
        a.add(v, n)
        b.add(v, n)
    assert a.item() == b.item() and a.n == b.n


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(20, 14), (5, 3), (9, 31)])
def test_resize_bilinear_np_matches_jax(rng, align_corners, out_hw):
    x = rng.standard_normal((7, 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(resize_bilinear_np(x, out_hw, align_corners),
                                  j_resize(x, out_hw, align_corners))


@pytest.mark.parametrize("kw", [{"scale": 0.5}, {"scale": 1 / 3},
                                {"scale": 2.0}, {"output_shape": (7, 11)}])
def test_imresize_matches_jax(rng, kw):
    x = rng.random((18, 21, 3))
    np.testing.assert_array_equal(imresize(x, **kw), j_imresize(x, **kw))
    u8 = (x * 255).astype(np.uint8)
    np.testing.assert_array_equal(imresize(u8, **kw), j_imresize(u8, **kw))
    np.testing.assert_array_equal(imresize(x[..., 0], method="bilinear", **kw),
                                  j_imresize(x[..., 0], method="bilinear", **kw))


def _same_item(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        # the JAX residual may come from its native C++ resize
        atol = 3e-6 if k == "gt_lr_up" else 0
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("lr_hw,s", [((8, 9), 2), ((10, 7), 3), ((7, 7), 4),
                                     ((9, 12), 2)])
def test_wrappers_match_jax(rng, lr_hw, s):
    pairs = _pairs(rng, 2, lr_hw, s)
    # an HR image past a multiple of the LR size is cropped
    pairs[1] = (pairs[1][0], np.pad(pairs[1][1], ((0, 1), (0, 2), (0, 0))))
    for port_cls, jax_cls in ((tw.SRImplicitPairedFast,
                               jw.SRImplicitPairedFast),
                              (tw.SRImplicitPairedFastPatch,
                               jw.SRImplicitPairedFastPatch)):
        port, ref = port_cls(pairs), jax_cls(pairs)
        assert len(port) == 2
        for i in range(2):
            _same_item(port[i], ref[i])
    item = tw.SRImplicitPairedFastPatch(pairs)[0]
    H, W = lr_hw[0] * s, lr_hw[1] * s
    assert item["gt_lr_up"].shape == (H // 3 + 1, W // 3 + 1, 27)
    assert item["coord"].shape == (H // 3 + 1, W // 3 + 1, 2)
    batch = next(tw.batches(tw.SRImplicitPairedFastPatch(pairs)))
    assert batch["inp"].shape == (1, *lr_hw, 3) and batch["cell"].shape == (1, 2)


def _jax_batches(wrapper):
    return [{k: np.asarray(v)[None] for k, v in wrapper[i].items()}
            for i in range(len(wrapper))]


def _pixel_models():
    jm = small_linf()
    jprior = jregistry.make({"name": "unet", "args": {"in_chans": 3,
                                                      "depth": 2, "dim": 16}})
    tprior = load_unet(registry.make(flagship_specs(tiny=True)[1]),
                       jax.tree_util.tree_map(np.asarray, jprior.params))
    return jm, jprior, port_of(jm), tprior.eval()


def _patch_models():
    jm = small_linf_patch()
    jprior = jregistry.make({"name": "unet", "args": {"in_chans": 27,
                                                      "depth": 2, "dim": 16}})
    tprior = load_unet(registry.make(patch_specs(tiny=True)[1]),
                       jax.tree_util.tree_map(np.asarray, jprior.params))
    return jm, jprior, patch_port_of(jm), tprior.eval()


@pytest.mark.parametrize("patch,eval_type,detail,with_prior", [
    (False, None, False, True),
    (False, "div2k-2", True, True),
    (False, "benchmark-2", False, False),
    (True, "div2k-2", True, True),
    (True, "benchmark-2", True, False),
    (True, None, False, True),
])
def test_eval_psnr_matches_jax(rng, patch, eval_type, detail, with_prior):
    jm, jprior, tm, tprior = _patch_models() if patch else _pixel_models()
    if not with_prior:
        jprior = tprior = None
    pairs = _pairs(rng)
    names = ("SRImplicitPairedFastPatch" if patch else "SRImplicitPairedFast")
    ref = j_eval_psnr(_jax_batches(getattr(jw, names)(pairs)), jm, jprior,
                      data_norm=NORM, eval_type=eval_type, scale_max=2,
                      detail=detail, patch=patch, log_fn=lambda *_: None)
    got = eval_psnr(tw.batches(getattr(tw, names)(pairs)), tm, tprior,
                    data_norm=NORM, eval_type=eval_type, scale_max=2,
                    detail=detail, patch=patch)
    if not detail:
        got, ref = {"psnr": got}, {"psnr": ref}
    else:
        assert set(got) == set(ref) and np.isnan(got["lpips"])
        del got["lpips"], ref["lpips"]
        assert abs(got["ssim"] - ref["ssim"]) < 1e-4
        del got["ssim"], ref["ssim"]
    for k in ref:
        assert np.isfinite(got[k]), k
        assert abs(got[k] - ref[k]) < 0.01, (k, got[k], ref[k])


def test_eval_psnr_twin_path_and_batches(rng):
    _, _, tm, tprior = _patch_models()
    pairs = _pairs(rng, 3)
    data = tw.SRImplicitPairedFastPatch(pairs)
    got = eval_psnr(tw.batches(data), tm, tprior, data_norm=NORM, patch=True)
    assert eval_psnr(tw.batches(data), tm, tprior, data_norm=NORM, patch=True,
                     kernels=False) == pytest.approx(got, abs=1e-6)
    # the mean over images, each image's PSNR weighted once
    each = [eval_psnr(tw.batches(tw.SRImplicitPairedFastPatch([p])), tm,
                      tprior, data_norm=NORM, patch=True) for p in pairs]
    assert got == pytest.approx(sum(each) / 3, abs=1e-9)
