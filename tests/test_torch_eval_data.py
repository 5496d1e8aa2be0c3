"""Port parity of the evaluation slice's host side: the downsampling
wrappers ``sr-implicit-downsampled-fast`` and its patch test form,
``paired-image-folders`` in its three cache modes, LPIPS on random
weights in the three checkpoint formats, and ``Measure`` /
``measure_dirs``, each against the JAX package's on the same inputs and
the same ``random`` / ``np.random`` seeds."""

import random

import jax
import numpy as np
import pytest
import torch

from bfsr_tpu.data import image_folder as jif
from bfsr_tpu.data import wrappers as jw
from bfsr_tpu.models import lpips as jlpips
from bfsr_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from bfsr_tpu.utils import measure as jmeasure
from bfsr_tpu_torch.convert.from_jax import lpips_state_dict
from bfsr_tpu_torch.data import image_folder as tif
from bfsr_tpu_torch.data import wrappers as tw
from bfsr_tpu_torch.models.lpips import LPIPS, load_lpips
from bfsr_tpu_torch.utils import measure as tmeasure

PIL = pytest.importorskip("PIL.Image")


def _items(wrapper, n, seed):
    """``n`` items of ``wrapper`` drawn in order after seeding ``random``
    and ``np.random`` with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return [wrapper[i % len(wrapper)] for i in range(n)]


def _same_items(got, ref):
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].shape == r[k].shape, k
            assert g[k].dtype == r[k].dtype, k
            # the JAX residuals may come from its native C++ resize
            atol = 3e-6 if k in ("gt_lr_up", "gt_pixel") else 0
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=atol,
                                       err_msg=k)


def _hr_images(rng, shapes=((40, 52), (45, 37), (36, 36))):
    return [rng.random((*s, 3)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kw", [
    {"scale_min": 4},                                  # the test configs
    {"scale_min": 3, "scale_max": 3, "augment": True},
    {"inp_size": 8, "scale_max": 4},                   # the val config
    {"inp_size": 9, "scale_min": 2, "scale_max": 4, "augment": True},
])
def test_downsampled_fast_matches_jax(rng, kw):
    data = _hr_images(rng)
    got = _items(tw.SRImplicitDownsampledFast(data, **kw), 5, 7)
    ref = _items(jw.SRImplicitDownsampledFast(data, **kw), 5, 7)
    _same_items(got, ref)
    if kw.get("inp_size"):
        n = kw["inp_size"]
        assert got[0]["coord"].shape == (n, n, 2)
        assert got[0]["gt_lr_up"].shape == (n, n, 3)


@pytest.mark.parametrize("kw", [
    {"scale_min": 4},
    {"scale_min": 2, "scale_max": 3},
    {"scale_min": 3, "patch_size": 5},
])
def test_downsampled_fast_patch_test_matches_jax(rng, kw):
    data = _hr_images(rng)
    got = _items(tw.SRImplicitDownsampledFastPatchTest(data, **kw), 4, 3)
    ref = _items(jw.SRImplicitDownsampledFastPatchTest(data, **kw), 4, 3)
    _same_items(got, ref)
    ps = kw.get("patch_size", 3)
    assert got[0]["gt_lr_up"].shape[-1] == 3 * ps * ps


def test_downsampled_fast_patch_test_with_inp_size_is_the_jax_fault(rng):
    """With ``inp_size`` the wrapper crops the coords to a window but
    unfolds the whole crop's residual: the JAX wrapper raises, or returns
    a residual grid that is not the coords' grid; the port keeps its
    semantics, draw for draw (ROADMAP.md queue 3)."""
    data = _hr_images(rng)

    def outcome(cls, seed):
        try:
            return _items(cls(data, inp_size=8, scale_min=2, scale_max=4), 1,
                          seed)
        except ValueError as e:
            return str(e)

    wrong = 0
    for seed in range(6):
        got = outcome(tw.SRImplicitDownsampledFastPatchTest, seed)
        ref = outcome(jw.SRImplicitDownsampledFastPatchTest, seed)
        if isinstance(ref, str):
            assert got == ref
            wrong += 1
            continue
        _same_items(got, ref)
        wrong += got[0]["gt_lr_up"].shape[:2] != got[0]["coord"].shape[:2]
    assert wrong == 6


def _write_folder(root, rng, shapes):
    root.mkdir()
    for i, s in enumerate(shapes):
        PIL.fromarray((rng.random((*s, 3)) * 255).astype(np.uint8)).save(
            root / f"{i:04d}.png")
    return str(root)


@pytest.mark.parametrize("cache", ["none", "bin", "in_memory"])
def test_paired_image_folders_match_jax(tmp_path, rng, cache):
    paths = {}
    for side in ("port", "jax"):
        # separate trees: the bin cache writes beside each folder
        r = np.random.default_rng(1)
        base = tmp_path / side
        base.mkdir()
        paths[side] = (_write_folder(base / "lr", r, [(8, 9), (7, 6)]),
                       _write_folder(base / "hr", r, [(32, 36), (28, 24)]))
    got = tif.PairedImageFolders(*paths["port"], cache=cache, repeat=2)
    ref = jif.PairedImageFolders(*paths["jax"], cache=cache, repeat=2)
    assert len(got) == len(ref) == 4
    for i in range(4):
        for g, r in zip(got[i], ref[i]):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, r)
    wrapped = tw.SRImplicitPairedFast(got)
    assert wrapped[0]["gt"].shape == (32, 36, 3)


def _jax_lpips_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jlpips.init_lpips(jax.random.PRNGKey(seed)))


def _port_lpips(params):
    m = LPIPS(seed=5)
    missing, unexpected = m.load_state_dict(lpips_state_dict(params),
                                            strict=False)
    assert not unexpected and all(k.startswith("scaling_layer.")
                                  for k in missing)
    return m


@pytest.mark.parametrize("hw", [(64, 64), (71, 90)])
def test_lpips_matches_jax(rng, hw):
    params = _jax_lpips_params()
    a = (rng.random((2, *hw, 3)) * 2 - 1).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(
        np.float32)
    ref = np.asarray(jlpips.lpips_distance(params, a, b))
    got = _port_lpips(params)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=1e-7)
    assert _port_lpips(params).score(a, b) == pytest.approx(
        jlpips.LPIPS(params)(a, b), rel=5e-5)
    assert float(got.min()) > 0


def test_load_lpips_takes_the_three_formats(tmp_path, rng):
    params = _jax_lpips_params(3)
    port = _port_lpips(params)
    a = (rng.random((1, 64, 64, 3)) * 2 - 1).astype(np.float32)
    b = -a
    want = port.score(a, b)
    # the published package's state_dict, without and with its constants
    sd = {k: v for k, v in port.state_dict().items()
          if not k.startswith("scaling_layer.")}
    torch.save(sd, tmp_path / "lpips_alex.pth")
    torch.save(port.state_dict(), tmp_path / "full.pth")
    j_save_checkpoint(str(tmp_path / "lpips.ckpt"), params)
    for name in ("lpips_alex.pth", "full.pth", "lpips.ckpt"):
        assert load_lpips(str(tmp_path / name), "cpu").score(a, b) == want, \
            name
    # the lin heads alone (the package's weight file) lack the AlexNet
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")},
               tmp_path / "lins.pth")
    with pytest.raises(ValueError, match="AlexNet"):
        load_lpips(str(tmp_path / "lins.pth"), "cpu")


def test_measure_matches_jax(rng):
    a = (rng.random((64, 70, 3)) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    assert tmeasure.psnr_uint8(a, b) == jmeasure.psnr_uint8(a, b)
    assert tmeasure.ssim_uint8(a, b) == jmeasure.ssim_uint8(a, b)
    assert tmeasure.ssim_uint8(a[..., 0], b[..., 0]) == \
        jmeasure.ssim_uint8(a[..., 0], b[..., 0])
    names = ["b10.png", "a2.png", "B1.png", "a10.png", "a1.png"]
    assert tmeasure.natsorted(names) == jmeasure.natsorted(names)
    params = _jax_lpips_params()
    got = tmeasure.Measure(_port_lpips(params)).measure(a, b)
    ref = jmeasure.Measure(jlpips.LPIPS(params)).measure(a, b)
    assert got[:2] == ref[:2]
    assert got[2] == pytest.approx(ref[2], rel=5e-5)
    assert np.isnan(tmeasure.Measure().lpips(a, b))


def test_measure_dirs_matches_jax(tmp_path, rng, capsys):
    da = _write_folder(tmp_path / "a", rng, [(20, 24), (22, 18), (20, 20)])
    db = _write_folder(tmp_path / "b", rng, [(20, 24), (22, 18), (20, 20)])
    got = tmeasure.measure_dirs(da, db)
    ref = jmeasure.measure_dirs(da, db)
    assert got["psnr"] == ref["psnr"] and got["ssim"] == ref["ssim"]
    assert np.isnan(got["lpips"]) and np.isnan(ref["lpips"])
    capsys.readouterr()
    assert tmeasure.main(["-dirA", da, "-dirB", db])["psnr"] == got["psnr"]
    assert "Final Result" in capsys.readouterr().out
    # LPIPS on the device asked for, on images AlexNet's taps can take
    da = _write_folder(tmp_path / "la", rng, [(64, 64), (64, 72)])
    db = _write_folder(tmp_path / "lb", rng, [(64, 64), (64, 72)])
    params = _jax_lpips_params()
    torch.save(_port_lpips(params).state_dict(), tmp_path / "lpips.pth")
    got = tmeasure.main(["-dirA", da, "-dirB", db, "--lpips_weights",
                         str(tmp_path / "lpips.pth"), "--device", "cpu"])
    ref = jmeasure.measure_dirs(da, db, lpips_model=jlpips.LPIPS(params))
    assert got["psnr"] == ref["psnr"]
    assert got["lpips"] == pytest.approx(ref["lpips"], rel=5e-5)
