"""Port parity for SRFlow at 16x (scale 16, L 4: levels on fea_up8 /
fea_up4 / fea_up2 / fea_up1, splits at levels 1 and 2, K5 at the 8x
model's C = 12, 24, 48 and 192), against the JAX ``SRFlowNet(scale=16,
L=4)`` on the same weights (through ``convert/from_jax.py``), at the tiny
config of ``tests/test_torch_srflow_x8.py`` (RRDB nf 8, nb 2, gc 4; K 2,
hidden 8, stack (0, 1)), with the flow live: the RRDB's x16 maps
(``fea_up16`` and ``fea_up8``, upconv3 and upconv4), the conditioning,
the encode's epses and the decode, the NLL, one base step in its frozen
and live forms, ``validate`` and the sampler at heat 0, the weights'
round trip with ``upconv4``, the ``lrhr-pkl`` scale check at 16 and the
CLIs on the shipped 16x conf at the tiny widths.

Tolerances (``docs/PARITY.md``'s module level, as the 8x files hold
them): 5e-5 absolute and 2e-5 relative for the maps, the epses and the
decode; the NLL and the loss within 1e-5 relative; each gradient within
1e-4 of its tensor's largest value (exactly zero where JAX's is); the
clipped heat-0 samples within 5e-4.
"""

import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.convert.torch_import import convert_srflow
from bfsr_tpu.models.rrdb import rrdb_apply_steps
from bfsr_tpu.models.srflow import flow_upsampler as fup
from bfsr_tpu.models.srflow.srflow_net import rrdb_preprocess as j_preprocess
from bfsr_tpu.pipelines.srflow_eval import sample_sr as j_sample_sr
from bfsr_tpu.pipelines.srflow_eval import validate as j_validate
from bfsr_tpu.pipelines.srflow_train import (
    make_srflow_train_step as j_make_step)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.cli import srflow_test as srflow_test_cli
from bfsr_tpu_torch.cli import srflow_train as srflow_train_cli
from bfsr_tpu_torch.convert.from_jax import srflow_state_dict
from bfsr_tpu_torch.data.pkl_dataset import LRHRPkl
from bfsr_tpu_torch.entry import (build_srflow_x16,
                                  example_srflow_train_batch,
                                  srflow_x16_spec)
from bfsr_tpu_torch.models.srflow.flow_upsampler import LEVEL_NAMES, build_plan
from bfsr_tpu_torch.models.srflow.srflow_net import rrdb_preprocess
from bfsr_tpu_torch.pipelines import srflow_train
from bfsr_tpu_torch.pipelines.srflow_eval import (lr_multiple, sample_sr,
                                                  validate)
from bfsr_tpu_torch.train.optim import make_optimizer
from bfsr_tpu_torch.utils.measure import psnr_uint8

from test_torch_srflow_models import _np_tree, live_flow
from test_torch_srflow_nll import jax_noise
from test_torch_srflow_x8_train import _jax_validate_noise, _write_pickles
from test_torch_train_step import grad_capture

yaml = pytest.importorskip("yaml")
Image = pytest.importorskip("PIL.Image")

TOL = {"rtol": 2e-5, "atol": 5e-5}
SPEC = srflow_x16_spec(tiny=True)
LR_HW = (2, 3)
HEAD = {f"RRDB.{m}.{p}" for m in ("upconv4", "HRconv", "conv_last")
        for p in ("weight", "bias")}


@functools.lru_cache(maxsize=None)
def _jax_model(frozen=False):
    """The JAX 16x SRFlowNet with a live flow, built once per process for
    each ``frozen``; callers must not change it."""
    jm = jregistry.make(SPEC)
    jm.params = live_flow(jm.params)
    return jm.freeze() if frozen else jm


def pair(frozen=False):
    """(JAX 16x SRFlowNet, live, frozen or not; a fresh port one on its
    weights, frozen)."""
    jm = _jax_model(frozen)
    tm = registry.make(SPEC)
    tm.load_state_dict(srflow_state_dict(_np_tree(jm.params), tm.plan))
    return jm, tm.eval().freeze()


def _inputs(seed=0, b=1):
    """(LR (b, 2, 3, 3), GT (b, 32, 48, 3)) in [0, 1] from a seed."""
    rng = np.random.default_rng(seed)
    h, w = LR_HW
    return (rng.random((b, h, w, 3)).astype(np.float32),
            rng.random((b, 16 * h, 16 * w, 3)).astype(np.float32))


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               err_msg=err_msg, **TOL)


def test_plan_and_levels_match_jax():
    """``build_plan(16, 4)`` is the 8x model's plan (C = 12, 24, 48, 192;
    no C = 384) and ``LEVEL_NAMES[16]`` the JAX one's."""
    got, got_c = build_plan(16, 4, 16, 2, True)
    ref, ref_c = fup.build_plan(16, 4, 16, 2, True)
    assert got == ref and got_c == ref_c == 192
    assert got == build_plan(8, 4, 16, 2, True)[0]
    conds = [e["c"] for e in got if e["kind"] == "step_cond"]
    assert conds == [12] * 16 + [24] * 16 + [48] * 16 + [192] * 16
    assert LEVEL_NAMES[16] == fup.LEVEL_NAMES[16]
    _, tm = pair()
    assert tm.cond_keys() == ["fea_up8", "fea_up4", "fea_up2", "fea_up1"]


@functools.lru_cache(maxsize=None)
def _jax_rrdb_maps():
    """The JAX RRDB's maps of ``_inputs()``'s LR, once per process."""
    lr, _ = _inputs()
    return rrdb_apply_steps(_jax_model().params["rrdb"], jnp.asarray(lr),
                            scale=16, block_idxs=(0, 1), fea_up0=True)


@pytest.mark.parametrize("kernels", [True, False])
def test_rrdb_x16_maps_match_jax(kernels):
    """``RRDBNet.steps`` at 16x: ``fea_up8`` (upconv3) and ``fea_up16``
    (upconv4) when asked for, the maps the flow reads otherwise, and
    nothing past the deepest one asked for."""
    _, tm = pair()
    lr, _ = _inputs()
    ref = _jax_rrdb_maps()
    keys = ("fea_up16", "fea_up8", "fea_up4", "fea_up2", "fea_up1")
    with torch.no_grad():
        got = tm.RRDB.steps(torch.from_numpy(lr), keys, (0, 1), kernels)
        assert set(got) == {"block_0", "block_1", *keys}
        for k in keys:
            _close(got[k], ref[k], err_msg=k)
        assert got["fea_up16"].shape[1:3] == (32, 48)
        flow_maps = tm.RRDB.steps(torch.from_numpy(lr), tm.cond_keys(),
                                  (), kernels)
    assert set(flow_maps) == set(tm.cond_keys())


def test_rrdb_preprocess_at_x16_matches_jax():
    jm, tm = pair()
    lr, _ = _inputs(1)
    ref = j_preprocess(jm.params["rrdb"], jnp.asarray(lr), 16, (0, 1),
                       fea_up0=True)
    with torch.no_grad():
        got = rrdb_preprocess(tm.RRDB, torch.from_numpy(lr), (0, 1),
                              tm.cond_keys())
    for k in tm.cond_keys():
        assert got[k].shape[-1] == 24
        _close(got[k], ref[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_flow_refs():
    """The frozen JAX model's epses of ``_inputs(2)``, their decode and its
    heat-0 sample, once per process."""
    jm = _jax_model(True)
    lr, gt = _inputs(2)
    ref, _, _ = jm.normal_flow(jm.params, jnp.asarray(gt), jnp.asarray(lr),
                               add_gt_noise=False, want_logdet=False)
    ref_sr, _ = jm.reverse_flow(jm.params, jnp.asarray(lr), epses=ref,
                                want_logdet=False)
    return ref, ref_sr, jm.get_sr(jm.params, jnp.asarray(lr), heat=0.0)


@pytest.mark.parametrize("kernels", [True, False])
def test_encode_decode_and_heat_0_sample_match_jax(kernels):
    """The encode's three epses (6, 12 and 192 channels), the decode of
    the JAX epses, the round trip and ``get_sr`` at heat 0."""
    _, tm = pair(frozen=True)
    lr, gt = _inputs(2)
    ref, ref_sr, ref_heat0 = _jax_flow_refs()
    with torch.no_grad():
        cache = tm.precompute_ft(tm.rrdb_preprocess(torch.from_numpy(lr)))
        got = tm.normal_flow(torch.from_numpy(gt), cache, kernels)
        assert [tuple(e.shape) for e in got] == [
            (1, 16, 24, 6), (1, 8, 12, 12), (1, 2, 3, 192)]
        for g, r in zip(got, ref):
            _close(g, r)
        _close(tm.reverse_flow([torch.from_numpy(np.array(e)) for e in ref],
                               cache, kernels), ref_sr)
        _close(tm.reverse_flow(got, cache, kernels), gt)
        _close(tm.get_sr(torch.from_numpy(lr), heat=0.0, kernels=kernels),
               ref_heat0)


def test_sample_sr_at_x16_matches_jax():
    """The sampler at 16x: an odd LR padded to even, 16h x 16w out, the
    JAX sampler's image at heat 0; at a nonzero heat, on the port's own
    random flow, finite and the same under a seed."""
    jm, tm = pair(frozen=True)
    lr = np.random.default_rng(4).random((3, 2, 3)).astype(np.float32)
    assert lr_multiple(tm) == 2
    ref = j_sample_sr(jm, lr, heat=0.0)
    got = sample_sr(tm, lr, heat=0.0)
    assert got.shape == ref.shape == (48, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)
    tm = build_srflow_x16("cpu", tiny=True)
    hot = [sample_sr(tm, lr, heat=0.7, seed=s) for s in (3, 3)]
    assert torch.equal(hot[0], hot[1]) and torch.isfinite(hot[0]).all()


def test_weights_round_trip_with_upconv4():
    """The x16 RRDB carries ``upconv4`` both ways, and its head's forward
    gives the image at 16x."""
    jm, tm = pair()
    sd = tm.state_dict()
    assert {"RRDB.upconv3.weight", "RRDB.upconv4.weight",
            "RRDB.upconv4.bias"} <= set(sd)
    assert set(sd) == set(srflow_state_dict(_np_tree(jm.params), tm.plan))
    back = convert_srflow(sd, jm.plan, nb=2, scale=16, freeze=False)
    ref = _np_tree(jm.params)
    for k in ("upconv1", "upconv2", "upconv3", "upconv4", "hr_conv",
              "conv_last"):
        np.testing.assert_array_equal(np.asarray(back["rrdb"][k]["w"]),
                                      ref["rrdb"][k]["w"])
    lr, _ = _inputs()
    with torch.no_grad():
        img = tm.RRDB(torch.from_numpy(lr), kernels=False)
    assert tuple(img.shape) == (1, 32, 48, 3)


def _batch(seed=0):
    """B 2 of 32^2 GT over their 2^2 LQ (a 16 x 16 area mean)."""
    data = example_srflow_train_batch("cpu", seed, 2, 32, scale=16)
    return {k: v.numpy() for k, v in data.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX model's NLL, one base step of each form and ``validate`` at
    heat 0, run once."""
    jm = _jax_model()
    data = _batch()
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
    vdata = [_batch(3)]
    out["validate"] = (vdata, *j_validate(jm, vdata, heats=(0.0,),
                                          n_sample=1))
    return data, jax_noise(key, data["GT"].shape), out


def test_normal_flow_nll_at_x16_matches_jax(jax_runs):
    data, noise, out = jax_runs
    ref_e, ref_nll, ref_ld = out["nll"]
    _, tm = pair()
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


@pytest.mark.parametrize("form", ["frozen", "live"])
def test_base_step_at_x16_matches_jax(jax_runs, form):
    """One base step at 16x, loss and every gradient against JAX's; in the
    live form upconv3 trains (level 1 reads ``fea_up8``) and the head past
    it gets none."""
    data, noise, out = jax_runs
    ref, jmets = out[form]
    _, tm = pair()
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


def test_validate_at_x16_matches_jax_at_heat_0(jax_runs, monkeypatch):
    vdata, jnll, jsamples = jax_runs[2]["validate"]
    _, tm = pair()
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


def test_lrhr_pkl_checks_the_scale_at_16(tmp_path):
    """GT 160 over LQ 10 at scale 16, cropped to 80 on the LQ's grid; x8
    pickles under a 16x conf are refused."""
    p16 = _write_pickles(tmp_path, 2, 160, 16, "16")
    item = LRHRPkl(p16["GT"], p16["LQ"], gt_size=80, scale=16)[0]
    assert item["GT"].shape == (80, 80, 3) and item["LQ"].shape == (5, 5, 3)
    p8 = _write_pickles(tmp_path, 2, 160, 8, "8")
    with pytest.raises(ValueError, match="x16"):
        LRHRPkl(p8["GT"], p8["LQ"], scale=16)[0]


def _x16_conf(tmp_path, pre):
    """The shipped 16x conf at the tiny widths, on pickles the test
    writes."""
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "bfsr_tpu_torch", "configs",
                           "srflow_df2k_16x.yml")) as f:
        conf = yaml.safe_load(f)
    assert conf["scale"] == 16 and conf["network_G"]["upscale"] == 16
    assert conf["network_G"]["flow"]["L"] == 4 and "prior_model" not in conf
    paths = _write_pickles(tmp_path, 4, 32, 16)
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
    conf["name"] = "x16_smoke"
    return conf


def test_x16_conf_trainer_and_sampler_clis(tmp_path, monkeypatch, capsys):
    """The conf builds the 16x model; the trainer on it loads an x16 RRDB
    (``upconv4`` included) and writes a checkpoint; ``cli/srflow_test.py``
    samples from that checkpoint without a prior, image by image the
    port's ``sample_sr``."""
    monkeypatch.chdir(tmp_path)
    rrdb = registry.make({"name": "rrdb", "args": {
        "nf": 8, "nb": 2, "gc": 4, "no_upsampling": False, "scale": 16}})
    assert "upconv4.weight" in rrdb.state_dict()
    torch.save(rrdb.state_dict(), tmp_path / "rrdb_x16.pth")
    conf = _x16_conf(tmp_path, str(tmp_path / "rrdb_x16.pth"))
    built = srflow_train_cli.load_srflow(conf, "cpu")
    assert (built.scale, built.L, built.final_c) == (16, 4, 192)
    path = tmp_path / "x16.yml"
    path.write_text(yaml.safe_dump(conf))
    srflow_train_cli.cli([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded pretrained RRDB" in out and "iter 1: nll_loss=" in out
    latest = tmp_path / "save" / "x16_smoke" / "G_latest.ckpt"
    sd = torch.load(latest, weights_only=True)["model"]["sd"]
    torch.testing.assert_close(sd["RRDB.upconv4.weight"],
                               rrdb.upconv4.weight.detach())
    for d in ("lr", "hr"):
        os.makedirs(tmp_path / d)
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(3, 2), (2, 4)]):
        lr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        hr = (rng.random((16 * h, 16 * w, 3)) * 255).astype(np.uint8)
        Image.fromarray(lr).save(tmp_path / "lr" / f"{i:04d}.png")
        Image.fromarray(hr).save(tmp_path / "hr" / f"{i:04d}.png")
    conf.update(dataroot_LR=str(tmp_path / "lr"),
                dataroot_GT=str(tmp_path / "hr"), model_path=str(latest))
    path.write_text(yaml.safe_dump(conf))
    rows = srflow_test_cli.main([str(path), "--device", "cpu", "--no_lpips"])
    with open(tmp_path / "results" / "SRFlow" / "measure_full.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    model = srflow_train_cli.load_srflow(conf, "cpu")
    lr = np.asarray(Image.open(tmp_path / "lr" / "0000.png"))
    sr = sample_sr(model, lr.astype(np.float32) / 255.0, 0.0, seed=0)
    assert sr.shape == (48, 32, 3)
    sr = np.round(sr.numpy() * 255.0).astype(np.uint8)
    hr = np.asarray(Image.open(tmp_path / "hr" / "0000.png"))
    assert abs(rows[0]["PSNR"] - psnr_uint8(sr, hr)) < 1e-9
