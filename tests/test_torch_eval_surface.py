"""The rest of ``eval_psnr``'s surface against the JAX ``eval_psnr`` on
the same pairs and weights: the window / ``pad_multiple`` protocol,
``randomness`` with ``temperature`` (5 samples at matched latents and
their diversity), ``sample`` (the saved PNG), ``detail`` with LPIPS and
``limit``; ``warmup_predictor``; and ``SRFlowLPPredictor``'s
``pad_multiple``."""

import jax
import numpy as np
import pytest
import torch

from bfsr_tpu.data import wrappers as jw
from bfsr_tpu.models import lpips as jlpips
from bfsr_tpu.pipelines.linf_eval import LINFPredictor as JPredictor
from bfsr_tpu.pipelines.linf_eval import eval_psnr as j_eval_psnr
from bfsr_tpu_torch.data import wrappers as tw
from bfsr_tpu_torch.entry import build_srflow_lp
from bfsr_tpu_torch.pipelines import linf_eval
from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr, warmup_predictor
from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                  pad_to_multiple)

from test_torch_eval import NORM, _jax_batches, _pairs, _pixel_models
from test_torch_eval_data import _jax_lpips_params, _port_lpips

QUIET = {"log_fn": lambda *_: None}


def _both(pairs, jm, jprior, tm, tprior, **kw):
    ref = j_eval_psnr(_jax_batches(jw.SRImplicitPairedFast(pairs)), jm,
                      jprior, data_norm=NORM, **QUIET, **kw)
    kw = {k: (_port_lpips(v.params) if k == "lpips_model" else v)
          for k, v in kw.items()}
    got = eval_psnr(tw.batches(tw.SRImplicitPairedFast(pairs)), tm, tprior,
                    data_norm=NORM, **QUIET, **kw)
    return got, ref


def _close(got, ref, tol=None):
    tol = {"psnr": 0.01, "LR recon": 0.01, "ssim": 1e-4, "lpips": 1e-4,
           "diversity": 1e-3, **(tol or {})}
    if not isinstance(ref, dict):
        got, ref = {"psnr": got}, {"psnr": ref}
    assert set(got) == set(ref)
    for k in ref:
        if k == "lpips" and np.isnan(ref[k]):
            assert np.isnan(got[k])
            continue
        assert np.isfinite(got[k]), k
        assert abs(got[k] - ref[k]) <= tol[k], (k, got[k], ref[k])


@pytest.mark.parametrize("kw", [
    {"window_size": 4, "eval_type": "div2k-2"},
    {"pad_multiple": 5, "eval_type": "benchmark-2", "detail": True},
])
def test_window_and_pad_multiple_match_jax(rng, kw):
    jm, jprior, tm, tprior = _pixel_models()
    pairs = _pairs(rng, 2, (8, 9), 2)
    _close(*_both(pairs, jm, jprior, tm, tprior, scale_max=2, **kw))


def test_window_refuses_patch():
    with pytest.raises(ValueError, match="patch"):
        eval_psnr([], None, window_size=4, patch=True)


def _jax_draws(jm, idx_samples, hw):
    """The standard-normal latents the JAX predictor draws on the CPU for
    image idx, sample s (key idx 131 + s; one draw per query tile)."""
    H, W = hw
    T = JPredictor(jm, None, use_pallas=False)._tile_rows(W, H)
    n_tiles = -(-H // T)
    out = {}
    for idx, s in idx_samples:
        keys = jax.random.split(jax.random.PRNGKey(idx * 131 + s), n_tiles)
        z = np.concatenate([np.asarray(jax.random.normal(k, (T * W, 3)))
                            .reshape(1, T, W, 3) for k in keys], 1)
        out[idx * 131 + s] = torch.from_numpy(z[:, :H])
    return out


def test_randomness_at_matched_latents_matches_jax(rng, monkeypatch):
    """No prior, temperature 0.8, 5 samples an image: the port's latents
    replaced by the JAX predictor's draws, every metric and the
    diversity agree."""
    jm, _, tm, _ = _pixel_models()
    pairs = _pairs(rng, 2, (16, 16), 4)
    draws = _jax_draws(jm, [(i, s) for i in range(2) for s in range(5)],
                       (64, 64))
    monkeypatch.setattr(linf_eval, "draw_latent",
                        lambda shape, seed, device: draws[seed])
    params = _jax_lpips_params()
    got, ref = _both(pairs, jm, None, tm, None, scale_max=4, detail=True,
                     randomness=True, temperature=0.8,
                     lpips_model=jlpips.LPIPS(params))
    assert ref["diversity"] > 1.0
    _close(got, ref)


def test_temperature_draws_are_seeded_per_image_and_sample(rng):
    _, _, tm, _ = _pixel_models()
    pairs = _pairs(rng, 2, (8, 8), 2)

    def run(**kw):
        return eval_psnr(tw.batches(tw.SRImplicitPairedFast(pairs)), tm,
                         data_norm=NORM, scale_max=2, detail=True, **QUIET,
                         **kw)

    a = run(randomness=True, temperature=0.8)
    assert np.isnan(a.pop("lpips"))
    again = run(randomness=True, temperature=0.8)
    assert np.isnan(again.pop("lpips")) and again == a
    assert a["diversity"] > 0
    assert run(randomness=True)["diversity"] == 0.0


def test_sample_saves_the_first_images_as_jax(rng, tmp_path):
    from PIL import Image

    jm, jprior, tm, tprior = _pixel_models()
    pairs = _pairs(rng, 3, (8, 9), 2)
    paths = {side: tmp_path / side for side in ("port", "jax")}
    ref = j_eval_psnr(_jax_batches(jw.SRImplicitPairedFast(pairs)), jm,
                      jprior, data_norm=NORM, scale_max=2, sample=2,
                      save_path=str(paths["jax"]), **QUIET)
    got = eval_psnr(tw.batches(tw.SRImplicitPairedFast(pairs)), tm, tprior,
                    data_norm=NORM, scale_max=2, sample=2,
                    save_path=str(paths["port"]), **QUIET)
    _close(got, ref)
    names = sorted(p.name for p in paths["port"].iterdir())
    assert names == sorted(p.name for p in paths["jax"].iterdir()) == [
        "801x2.png", "802x2.png"]
    for n in names:
        a = np.asarray(Image.open(paths["port"] / n), np.int32)
        b = np.asarray(Image.open(paths["jax"] / n), np.int32)
        assert a.shape == (16, 18, 3) and np.abs(a - b).max() <= 1


def test_detail_with_lpips_and_limit_match_jax(rng):
    jm, jprior, tm, tprior = _pixel_models()
    pairs = _pairs(rng, 3, (16, 16), 4)
    got, ref = _both(pairs, jm, jprior, tm, tprior, eval_type="div2k-4",
                     detail=True, limit=2,
                     lpips_model=jlpips.LPIPS(_jax_lpips_params()))
    assert np.isfinite(ref["lpips"]) and ref["lpips"] > 0
    _close(got, ref)


def test_warmup_predicts_each_bucket_once(rng):
    _, _, tm, tprior = _pixel_models()
    logs = []
    got = warmup_predictor(tm, tprior, [(8, 9), (9, 8), (8, 9), (6, 7)], 2,
                           pad_multiple=4, log_fn=logs.append)
    assert got == [(12, 12), (8, 8)] and len(logs) == 2
    assert warmup_predictor(tm, None, [(8, 9), (8, 9)], 3,
                            log_fn=logs.append) == [(8, 9)]


@pytest.mark.parametrize("hw,m", [((7, 5), 2), ((9, 6), 8), ((5, 8), 4)])
def test_pad_to_multiple_is_the_jax_pad(rng, hw, m):
    x = rng.random((*hw, 3)).astype(np.float32)
    ph, pw = -hw[0] % m, -hw[1] % m
    want = np.pad(x, ((0, ph), (0, pw), (0, 0)),
                  "symmetric" if m > 2 else "reflect")
    np.testing.assert_array_equal(
        pad_to_multiple(torch.from_numpy(x), m)[0].numpy(), want)


def test_srflow_predictor_crops_its_padded_prediction(rng):
    model, prior = build_srflow_lp("cpu", seed=0, tiny=True)
    lr = torch.from_numpy(rng.random((6, 5, 3)).astype(np.float32))
    pred = SRFlowLPPredictor(model, prior, pad_multiple=8)
    assert pred.pad_multiple == 8
    assert SRFlowLPPredictor(model, prior, pad_multiple=0).pad_multiple == 2
    sr = pred.predict(lr)
    full = pred.run(pad_to_multiple(lr, 8))
    s = model.scale
    assert sr.shape == (6 * s, 5 * s, 3)
    assert torch.equal(sr, torch.clamp(full[0], 0, 1)[:6 * s, :5 * s])
