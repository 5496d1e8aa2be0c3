"""The port's native host library (``bfsr_tpu_torch/native.py``, built from
``csrc/host/bfsr_native.cc``) on the CPU: each entry against its plain
numpy twin and against the JAX package's ``bfsr_tpu.native`` on the same
inputs, the wrappers that compute their residuals with it against the JAX
wrappers, a concurrent build from an empty build directory, and a failing
build, which raises instead of falling back to numpy.

The comparisons with ``bfsr_tpu.native`` build its source,
``native/bfsr_native.cc``, with ``native/Makefile``'s flags into a
directory of this process's own and point ``bfsr_tpu.native`` at that
library (``jax_native``).  Its own loader rebuilds ``native/
libbfsr_native.so`` in place whenever the file is missing or older than
its sources, so that processes which load it at once (pytest's workers)
can read it half written and take the library for missing."""

import random
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from bfsr_tpu import native as jnative
from bfsr_tpu.data import wrappers as jw
from bfsr_tpu_torch import native
from bfsr_tpu_torch.data import wrappers as tw
from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
from bfsr_tpu_torch.ops.imresize import imresize

ROOT = Path(__file__).resolve().parents[1]
# (LR, out): up, down, ragged both ways
BILINEAR_CASES = [((23, 17), (46, 40)), ((40, 52), (13, 17)),
                  ((9, 9), (18, 20)), ((31, 12), (7, 45))]
RESIDUAL_CASES = [((16, 12), (48, 36)), ((12, 12), (48, 48)),
                  ((13, 17), (39, 68)), ((10, 7), (35, 22))]
BICUBIC_CASES = [((20, 24), (10, 12)), ((20, 24), (45, 50)),
                 ((33, 19), (11, 40)), ((17, 29), (51, 9))]
JAX_TOL = 1e-6


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``bfsr_tpu.native`` on a library built from ``native/bfsr_native.cc``
    with ``native/Makefile``'s compiler and flags into this process's own
    temporary directory; a failed build fails the test."""
    make = (ROOT / "native" / "Makefile").read_text()
    cxx = re.search(r"^CXX \?= (.+)$", make, re.M).group(1).split()
    flags = re.search(r"^CXXFLAGS \?= (.+)$", make, re.M).group(1).split()
    so = tmp_path_factory.mktemp("jax_native") / "libbfsr_native.so"
    subprocess.run([*cxx, *flags, "-o", str(so),
                    str(ROOT / "native" / "bfsr_native.cc")], check=True,
                   capture_output=True, timeout=120)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO_PATH", str(so))
        mp.setattr(jnative, "_stale", lambda: False)
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        assert jnative.available()
        yield jnative


def _img(rng, hw, c=3):
    return rng.random((*hw, c)).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", BILINEAR_CASES)
def test_bilinear_matches_numpy(rng, in_hw, out_hw, align_corners):
    x = _img(rng, in_hw)
    got = native.bilinear_resize(x, out_hw, align_corners)
    assert got.shape == (*out_hw, 3) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, resize_bilinear_np(x, out_hw, align_corners), rtol=0, atol=2e-6)


@pytest.mark.parametrize("lr_hw,hr_hw", RESIDUAL_CASES)
def test_residual_matches_numpy_twin(rng, lr_hw, hr_hw):
    lr = _img(rng, lr_hw)
    lr_up, res = tw.residuals(lr, hr_hw)
    ref_up, ref_res = tw.residuals_np(lr, hr_hw)
    assert lr_up.dtype == res.dtype == np.float32
    assert lr_up.shape == res.shape == (*hr_hw, 3)
    np.testing.assert_allclose(lr_up, ref_up, rtol=0, atol=3e-6)
    np.testing.assert_allclose(res, ref_res, rtol=0, atol=5e-6)
    # the wrappers' residual is the native entry's on the normalised LR
    for a, b in zip((lr_up, res),
                    native.updownup_residual((lr - 0.5) / 0.5, hr_hw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("in_hw,out_hw", BICUBIC_CASES)
def test_bicubic_matches_imresize(rng, in_hw, out_hw):
    x = _img(rng, in_hw)
    got = native.bicubic_resize(x, out_hw)
    ref = imresize(x.astype(np.float64), output_shape=out_hw)
    assert got.shape == ref.shape == (*out_hw, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", BILINEAR_CASES)
def test_bilinear_matches_jax_native(jax_native, rng, in_hw, out_hw,
                                     align_corners):
    x = _img(rng, in_hw)
    np.testing.assert_allclose(
        native.bilinear_resize(x, out_hw, align_corners),
        jax_native.bilinear_resize(x, out_hw, align_corners), rtol=0,
        atol=JAX_TOL)


@pytest.mark.parametrize("lr_hw,hr_hw", RESIDUAL_CASES)
def test_residual_matches_jax_native(jax_native, rng, lr_hw, hr_hw):
    lr_norm = (_img(rng, lr_hw) - 0.5) / 0.5
    for got, ref in zip(native.updownup_residual(lr_norm, hr_hw),
                        jax_native.updownup_residual(lr_norm, hr_hw)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("in_hw,out_hw", BICUBIC_CASES)
def test_bicubic_matches_jax_native(jax_native, rng, in_hw, out_hw):
    x = _img(rng, in_hw)
    np.testing.assert_allclose(native.bicubic_resize(x, out_hw),
                               jax_native.bicubic_resize(x, out_hw), rtol=0,
                               atol=JAX_TOL)


def _same_items(got, ref, residual_keys):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == ref[k].dtype, k
        atol = 3e-6 if k in residual_keys else 0
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("lr_hw,s", [((8, 9), 2), ((10, 7), 3), ((9, 12), 4)])
def test_paired_fast_matches_jax(rng, lr_hw, s):
    lr = _img(rng, lr_hw)
    hr = _img(rng, (lr_hw[0] * s + 1, lr_hw[1] * s + 2))
    got = tw.SRImplicitPairedFast([(lr, hr)])[0]
    _same_items(got, jw.SRImplicitPairedFast([(lr, hr)])[0], ("gt_lr_up",))
    hr_hw = (lr_hw[0] * s, lr_hw[1] * s)
    np.testing.assert_array_equal(got["gt_lr_up"],
                                  tw.residuals(lr, hr_hw)[1])


@pytest.mark.parametrize("augment", [False, True])
def test_crop_matches_jax(augment):
    pytest.importorskip("PIL")
    img = np.random.default_rng(1).random((70, 66, 3)).astype(np.float32)
    args = {"inp_size": 12, "scale_max": 4, "augment": augment}
    ours = tw.SRImplicitDownsampledFastCrop([img], **args)
    theirs = jw.SRImplicitDownsampledFastCrop([img], **args)
    for seed in range(3):
        random.seed(seed)
        got = ours[0]
        random.seed(seed)
        _same_items(got, theirs[0], ("gt_lr_up", "gt_pixel"))


@pytest.mark.parametrize("patch", [False, True])
def test_loader_times_clocks_the_wrappers_own_items(patch):
    """``loader_times.stage_clock`` times the wrapper's own ``__getitem__``
    stage by stage and leaves its items as they are; ``stage_split``
    reports every stage."""
    pytest.importorskip("PIL")
    from bfsr_tpu_torch.profiling import loader_times as lt

    images = lt.hr_images(2, (60, 64))
    data = lt.crop_wrapper(images, patch, inp=4)
    random.seed(3)
    want = [data[i] for i in range(2)]
    clock = {}
    random.seed(3)
    with lt.stage_clock(clock):
        got = [data[i] for i in range(2)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    stages = ["pil_resize", "flips", "residual", "coords"] + (
        ["patch_centres"] if patch else [])
    assert sorted(clock) == sorted(stages)
    assert all(v > 0 for v in clock.values())
    med = lt.stage_split(images, patch, reps=2, inp=4)
    assert sorted(med) == sorted(stages + ["rest", "stack", "sample"])
    assert med["sample"] == pytest.approx(
        sum(v for k, v in med.items() if k != "sample"))


def _run(code, *args):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_processes_build_one_library(tmp_path):
    """Two processes building into an empty directory at once both load the
    same library, and no temporary file is left behind."""
    code = """
        import sys
        from pathlib import Path
        import numpy as np
        from bfsr_tpu_torch import native
        native.BUILD_DIR = Path(sys.argv[1])
        lib = native.library()
        up, res = native.updownup_residual(np.ones((3, 4, 3), np.float32),
                                           (6, 8))
        assert np.all(up == 1) and np.all(res == 0)
        print(lib._name)
    """
    procs = [_run(code, tmp_path) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    built = sorted(tmp_path.iterdir())
    assert len(names) == 1 and [str(b) for b in built] == list(names), (
        names, built)


def test_failing_build_raises(tmp_path, monkeypatch, rng):
    """No numpy fallback: a missing compiler or a source that does not
    compile raises, from the library and from the wrappers' residual."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    lr = _img(rng, (6, 5))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.library()
    with pytest.raises(RuntimeError, match="native build failed"):
        tw.residuals(lr, (12, 10))
    monkeypatch.undo()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cc"
    bad.write_text("extern \"C\" int bilinear_resize_f32( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="native build failed"):
        tw.SRImplicitPairedFast([(lr, _img(rng, (12, 10)))])[0]
    assert native._lib is None
    assert not list((tmp_path / "build").glob("*.so"))

