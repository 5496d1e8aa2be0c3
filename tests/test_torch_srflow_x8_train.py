"""Port parity for SRFlow's 8x model (scale 8, L 4) in training and
serving, on the CPU: the NLL (``normal_flow_nll``: three epses, two
splits' log-likelihoods), one base train step in its frozen-RRDB and live
forms (loss and every gradient) and ``validate`` at heat 0, each against
the JAX package on the same weights, batch and quantisation noise, at the
tiny config of ``tests/test_torch_srflow_x8.py`` (B 2 of 32^2 GT over 4^2
LQ); the ``lrhr-pkl`` dataset's scale check (GT 160 over LQ 20); and the
CLIs on the 8x conf (``bfsr_tpu_torch/configs/srflow_df2k_8x.yml`` at the
tiny widths): the trainer with an x8 ``pretrain_model_G`` (``upconv3``
included) and the sampler mode of ``cli/srflow_test.py``.

Limits, as ``tests/test_torch_srflow_base_train.py`` holds the 4x step:
the NLL and the loss within 1e-5 relative, the epses within 5e-5, each
gradient within 1e-4 of its tensor's largest value (exactly zero where
JAX's is: the frozen RRDB; in the live form the head the flow never reads,
``upconv3``, ``HRconv`` and ``conv_last``); the heat-0 samples within
5e-4.
"""

import csv
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.pipelines.srflow_eval import validate as j_validate
from bfsr_tpu.pipelines.srflow_train import (
    make_srflow_train_step as j_make_step)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.cli import srflow_test as srflow_test_cli
from bfsr_tpu_torch.cli import srflow_train as srflow_train_cli
from bfsr_tpu_torch.convert.from_jax import srflow_state_dict
from bfsr_tpu_torch.data.pkl_dataset import LRHRPkl
from bfsr_tpu_torch.entry import (example_srflow_train_batch,
                                  synthetic_lrhr_sample)
from bfsr_tpu_torch.pipelines import srflow_train
from bfsr_tpu_torch.pipelines.srflow_eval import sample_sr, validate
from bfsr_tpu_torch.train.optim import make_optimizer
from bfsr_tpu_torch.utils.measure import psnr_uint8

from test_torch_srflow_models import _np_tree, live_flow
from test_torch_srflow_nll import jax_noise
from test_torch_srflow_x8 import _spec
from test_torch_train_step import grad_capture

yaml = pytest.importorskip("yaml")
Image = pytest.importorskip("PIL.Image")

TOL = {"rtol": 2e-5, "atol": 5e-5}
X8 = {"scale": 8, "L": 4}
HEAD = {f"RRDB.{m}.{p}" for m in ("upconv3", "HRconv", "conv_last")
        for p in ("weight", "bias")}


@functools.lru_cache(maxsize=1)
def _jax_model():
    jm = jregistry.make(_spec(X8))
    jm.params = live_flow(jm.params)
    return jm


def base_pair():
    """(JAX x8 SRFlowNet, live and unfrozen; a fresh port one on its
    weights, frozen)."""
    jm = _jax_model()
    tm = registry.make(_spec(X8))
    tm.load_state_dict(srflow_state_dict(_np_tree(jm.params), tm.plan))
    return jm, tm.freeze()


def batch(seed=0):
    """B 2 of 32^2 GT over their 4^2 LQ (an 8 x 8 area mean)."""
    data = example_srflow_train_batch("cpu", seed, 2, 32, scale=8)
    return {k: v.numpy() for k, v in data.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX model's NLL, one step of each form and ``validate`` at heat
    0, run once."""
    jm = _jax_model()
    data = batch()
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    key = jax.random.PRNGKey(7)
    epses, nll, logdet = jm.normal_flow(jm.params, jb["GT"], jb["LQ"],
                                        key=key)
    out = {"nll": (_np_tree(epses), np.asarray(nll), np.asarray(logdet))}
    for form in ("frozen", "live"):
        kw = ({"freeze_rrdb": True} if form == "frozen"
              else {"rrdb_unfreeze_step": 0})
        step = j_make_step(jm, grad_capture(), 1.0, 0.0, **kw)
        _, grads, mets = step(jm.params, grad_capture().init(jm.params), jb,
                              key, jnp.asarray(0))
        out[form] = (srflow_state_dict(_np_tree(grads), jm.plan),
                     {k: float(v) for k, v in mets.items()})
    vdata = [batch(3)]
    out["validate"] = (vdata, *j_validate(jm, vdata, heats=(0.0,),
                                          n_sample=1))
    return data, jax_noise(key, data["GT"].shape), out


def test_normal_flow_nll_at_x8_matches_jax(jax_runs):
    data, noise, out = jax_runs
    ref_e, ref_nll, ref_ld = out["nll"]
    _, tm = base_pair()
    with torch.no_grad():
        cache = tm.precompute_ft(tm.rrdb_preprocess(
            torch.from_numpy(data["LQ"])))
        epses, nll, logdet = tm.normal_flow_nll(
            torch.from_numpy(data["GT"]), cache, torch.from_numpy(noise))
    assert [tuple(e.shape) for e in epses] == [
        (2, 16, 16, 6), (2, 8, 8, 12), (2, 2, 2, 192)]
    for g, r in zip(epses, ref_e):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    np.testing.assert_allclose(nll.numpy(), ref_nll, rtol=1e-5)
    np.testing.assert_allclose(logdet.numpy(), ref_ld, rtol=1e-5)
    # the log-det decode takes the epses back, its log-det cancelling
    with torch.no_grad():
        x, back = tm.reverse_flow_logdet(epses, cache)
    np.testing.assert_allclose(x.numpy(), data["GT"] + noise, **TOL)
    assert torch.isfinite(back).all()


@pytest.mark.parametrize("form", ["frozen", "live"])
def test_base_step_at_x8_matches_jax(jax_runs, form):
    """One base step at x8: the frozen form (the RRDB under no_grad on
    K3's twin) and the live form, loss and gradients against JAX's."""
    data, noise, out = jax_runs
    ref, jmets = out[form]
    _, tm = base_pair()
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-3}},
                         tm.parameters())
    kw = ({"freeze_rrdb": True} if form == "frozen"
          else {"rrdb_unfreeze_step": 0})
    step = srflow_train.make_srflow_train_step(tm, opt, 1.0, 0.0, **kw)
    mets, grads = step.loss_and_grads(data, 0, torch.from_numpy(noise))
    assert set(mets) == set(jmets) == {"nll_loss", "loss"}
    for k in mets:
        np.testing.assert_allclose(float(mets[k]), jmets[k], rtol=1e-5,
                                   err_msg=k)
    assert set(grads) == set(ref)
    zero = set()
    for name, g in grads.items():
        r = ref[name].numpy()
        scale = np.abs(r).max()
        if scale == 0:
            assert not g.any(), name
            zero.add(name)
            continue
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    rrdb = {k for k in grads if k.startswith("RRDB.")}
    assert zero == (rrdb if form == "frozen" else HEAD)
    # x8 reads fea_up4: upconv2 trains in the live form
    assert "RRDB.upconv2.weight" not in zero or form == "frozen"


def _jax_validate_noise(gt_shape, n_draws, seed=0):
    """The quantisation noise JAX's ``validate`` draws for its NLL."""
    key = jax.random.PRNGKey(seed)
    for _ in range(n_draws + 1):
        key, sub = jax.random.split(key)
    return torch.from_numpy(jax_noise(sub, gt_shape))


def test_validate_at_x8_matches_jax_at_heat_0(jax_runs, monkeypatch):
    vdata, jnll, jsamples = jax_runs[2]["validate"]
    _, tm = base_pair()
    nll, samples = validate(tm, vdata, heats=(0.0,), n_sample=1)
    assert samples[0.0, 0].shape == (32, 32, 3)
    np.testing.assert_allclose(samples[0.0, 0].numpy(), jsamples[0.0, 0],
                               atol=5e-4)
    noise = _jax_validate_noise(vdata[0]["GT"].shape, 1)
    monkeypatch.setattr(tm, "normal_flow_nll",
                        functools.partial(tm.normal_flow_nll, noise=noise))
    fixed, _ = validate(tm, vdata, heats=(0.0,), n_sample=1)
    assert np.isfinite(nll)
    assert abs(fixed - jnll) <= 1e-5 * abs(jnll), (fixed, jnll)


def _write_pickles(tmp_path, n=6, gt=32, scale=8, tag=""):
    rng = np.random.default_rng(2)
    samples = [synthetic_lrhr_sample(rng, gt, scale) for _ in range(n)]
    paths = {}
    for key in ("GT", "LQ"):
        paths[key] = str(tmp_path / f"{key}{tag}.pklv4")
        with open(paths[key], "wb") as f:
            pickle.dump([(s[key] * 255).astype(np.uint8) for s in samples], f)
    return paths


def test_lrhr_pkl_checks_the_scale(tmp_path):
    """GT 160 over LQ 20 at scale 8, cropped to 80 on the LQ's grid; x4
    pickles under an x8 conf are refused."""
    p8 = _write_pickles(tmp_path, 2, 160, 8, "8")
    ds = LRHRPkl(p8["GT"], p8["LQ"], gt_size=80, scale=8)
    item = ds[0]
    assert item["GT"].shape == (80, 80, 3) and item["LQ"].shape == (10, 10, 3)
    p4 = _write_pickles(tmp_path, 2, 160, 4, "4")
    with pytest.raises(ValueError, match="x8"):
        LRHRPkl(p4["GT"], p4["LQ"], scale=8)[0]
    assert LRHRPkl(p4["GT"], p4["LQ"], scale=4)[1]["LQ"].shape == (40, 40, 3)


def _x8_conf(tmp_path, pre):
    """The shipped 8x conf at the tiny widths, on pickles and PNGs the
    test writes."""
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "bfsr_tpu_torch", "configs",
                           "srflow_df2k_8x.yml")) as f:
        conf = yaml.safe_load(f)
    assert conf["scale"] == 8 and conf["network_G"]["flow"]["L"] == 4
    assert "prior_model" not in conf
    paths = _write_pickles(tmp_path)
    tr = conf["datasets"]["train"]
    tr.update(dataroot_GT=paths["GT"], dataroot_LQ=paths["LQ"], batch_size=2,
              n_workers=1, GT_size=None)
    g = conf["network_G"]
    g.update(nf=8, nb=2, gc=4)
    g["flow"].update(K=2, hidden_channels=8)
    g["flow"]["stackRRDB"]["blocks"] = [0, 1]
    conf["path"]["pretrain_model_G"] = pre
    conf["train"].update(niter=2)
    conf["logger"].update(print_freq=1, save_checkpoint_freq=10)
    conf["name"] = "x8_smoke"
    return conf


def test_x8_trainer_and_sampler_clis(tmp_path, monkeypatch, capsys):
    """The trainer on the 8x conf: the x8 RRDB of ``pretrain_model_G``
    (``upconv3`` included) loaded and held while frozen, a checkpoint
    written; then ``cli/srflow_test.py`` on that checkpoint without a
    prior: the sampler at heat 0, image by image the port's
    ``sample_sr``."""
    monkeypatch.chdir(tmp_path)
    rrdb = registry.make({"name": "rrdb", "args": {
        "nf": 8, "nb": 2, "gc": 4, "no_upsampling": False, "scale": 8}})
    assert "upconv3.weight" in rrdb.state_dict()
    torch.save(rrdb.state_dict(), tmp_path / "rrdb_x8.pth")
    conf = _x8_conf(tmp_path, str(tmp_path / "rrdb_x8.pth"))
    path = tmp_path / "x8.yml"
    path.write_text(yaml.safe_dump(conf))
    srflow_train_cli.cli([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded pretrained RRDB" in out and "iter 1: nll_loss=" in out
    latest = tmp_path / "save" / "x8_smoke" / "G_latest.ckpt"
    sd = torch.load(latest, weights_only=True)["model"]["sd"]
    # the frozen phase (iteration 0 of 2) leaves the RRDB as loaded; the
    # live one trains it, but not the head the flow never reads
    torch.testing.assert_close(sd["RRDB.upconv3.weight"],
                               rrdb.upconv3.weight.detach())
    # the sampler: LR PNGs of odd sizes, padded to even
    for d in ("lr", "hr"):
        os.makedirs(tmp_path / d)
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(5, 6), (4, 7)]):
        lr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        hr = (rng.random((8 * h, 8 * w, 3)) * 255).astype(np.uint8)
        Image.fromarray(lr).save(tmp_path / "lr" / f"{i:04d}.png")
        Image.fromarray(hr).save(tmp_path / "hr" / f"{i:04d}.png")
    conf.update(dataroot_LR=str(tmp_path / "lr"),
                dataroot_GT=str(tmp_path / "hr"), model_path=str(latest))
    path.write_text(yaml.safe_dump(conf))
    rows = srflow_test_cli.main([str(path), "--device", "cpu", "--no_lpips",
                                 "--warmup"])
    with open(tmp_path / "results" / "SRFlow" / "measure_full.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    assert all(np.isfinite(r["PSNR"]) for r in rows)
    model = srflow_train_cli.load_srflow(conf, "cpu")
    lr = np.asarray(Image.open(tmp_path / "lr" / "0001.png"))
    sr = sample_sr(model, lr.astype(np.float32) / 255.0, 0.0, seed=1)
    assert sr.shape == (32, 56, 3)
    sr = np.round(sr.numpy() * 255.0).astype(np.uint8)
    hr = np.asarray(Image.open(tmp_path / "hr" / "0001.png"))
    assert abs(rows[1]["PSNR"] - psnr_uint8(sr, hr)) < 1e-9
