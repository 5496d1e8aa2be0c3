"""The evaluation entry points end to end on the CPU, on PNGs, YAML and
checkpoints the tests write: ``load_linf_model`` / ``load_prior_model`` on
the three checkpoint formats, ``cli/test.py`` on the three shipped test
configs (paths rewritten) and its flags, ``cli/srflow_test.py`` on the
SRFlow-LP conf's schema, and ``cli/train.py`` validating an epoch."""

import csv
import os
import pickle

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)
from bfsr_tpu import registry as jregistry
from bfsr_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from bfsr_tpu.utils.misc import Averager as JAverager
from bfsr_tpu_torch.cli import srflow_test as srflow_cli
from bfsr_tpu_torch.cli import test as test_cli
from bfsr_tpu_torch.convert.load import load_linf_model, load_prior_model
from bfsr_tpu_torch.entry import build_flagship, build_linf_patch
from bfsr_tpu_torch.models.lpips import LPIPS
from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr
from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor
from bfsr_tpu_torch.train import checkpoints as ckpt
from bfsr_tpu_torch.utils.measure import psnr_uint8

from test_pipelines import small_linf

yaml = pytest.importorskip("yaml")
Image = pytest.importorskip("PIL.Image")
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_load_linf_model_takes_three_formats(tmp_path):
    jm = small_linf()
    spec = {"name": "linf", "args": jm.args}
    j_save_checkpoint(str(tmp_path / "jax.ckpt"),
                      {"model": {**spec, "params": jm.params}})
    from_jax = load_linf_model(str(tmp_path / "jax.ckpt"), device="cpu")
    assert from_jax.imnet.w_inv is not None and not from_jax.training
    ckpt.save_checkpoint(str(tmp_path / "port.ckpt"),
                         {"model": {**from_jax.spec(),
                                    "sd": from_jax.state_dict()}})
    # a reference .pth, in torch's legacy (non-zip) format
    torch.save({"model": {**spec, "sd": from_jax.state_dict()}},
               tmp_path / "ref.pth", _use_new_zipfile_serialization=False)
    for name in ("port.ckpt", "ref.pth"):
        _same_state(load_linf_model(str(tmp_path / name), device="cpu"),
                    from_jax)
    assert load_linf_model(str(tmp_path / "ref.pth"), freeze=False,
                           device="cpu").imnet.w_inv is None
    from test_torch_info import port_of

    _same_state(from_jax, port_of(jm))


def test_a_checkpoint_that_needs_jax_is_refused(tmp_path):
    with open(tmp_path / "bad.ckpt", "wb") as f:
        pickle.dump({"model": JAverager()}, f)
    with pytest.raises(ValueError, match="bfsr_tpu.utils.misc.Averager"):
        load_linf_model(str(tmp_path / "bad.ckpt"), device="cpu")


class _Exec:
    """Pickles as a call of ``builtins.exec``."""

    def __reduce__(self):
        return exec, ("raise SystemExit('the pickle ran code')",)


@pytest.mark.parametrize("payload", [_Exec(), np.load],
                         ids=["builtins.exec", "numpy.load"])
def test_a_checkpoint_that_names_a_callable_is_refused(tmp_path, payload):
    with open(tmp_path / "bad.ckpt", "wb") as f:
        pickle.dump({"model": payload}, f)
    name = "builtins.exec" if isinstance(payload, _Exec) else "numpy.load"
    with pytest.raises(ValueError, match=name):
        load_linf_model(str(tmp_path / "bad.ckpt"), device="cpu")


def test_load_prior_model_takes_three_formats(tmp_path):
    jprior = jregistry.make({"name": "unet", "args": {
        "in_chans": 3, "depth": 2, "dim": 16}})
    j_save_checkpoint(str(tmp_path / "jax.ckpt"), {"prior_model": {
        "name": "unet", "args": jprior.args, "params": jprior.params}})
    prior = load_prior_model(str(tmp_path / "jax.ckpt"), "cpu")
    assert not prior.training
    ckpt.save_checkpoint(str(tmp_path / "port.ckpt"), {"prior_model": {
        **prior.spec(), "sd": prior.state_dict()}})
    torch.save({"prior_model": {"name": "unet", "args": jprior.args,
                                "sd": prior.state_dict()}},
               tmp_path / "ref.pth")
    for name in ("port.ckpt", "ref.pth"):
        _same_state(load_prior_model(str(tmp_path / name), "cpu"), prior)
    # the reference names SRFlow-LP's two-branch prior 'unet' too
    from bfsr_tpu_torch.entry import build_srflow_lp

    _, sprior = build_srflow_lp("cpu", tiny=True)
    torch.save({"prior_model": {"name": "unet", "args": sprior.args,
                                "sd": sprior.state_dict()}},
               tmp_path / "srflow_prior.pth")
    assert load_prior_model(str(tmp_path / "srflow_prior.pth"), "cpu"
                            ).registry_name == "srflow-unet"
    # a name that is no latent module is refused, naming the ones there are
    j_save_checkpoint(str(tmp_path / "mlp.ckpt"), {"prior_model": {
        "name": "mlp", "args": {}, "params": {}}})
    with pytest.raises(NotImplementedError, match="swin_latent"):
        load_prior_model(str(tmp_path / "mlp.ckpt"), "cpu")


def _write_pngs(root, shapes, seed):
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        # smooth images: PSNRs well above a random image's
        y, x = np.mgrid[:h, :w] / max(h, w)
        ph = rng.random(3) * 6
        img = 0.5 + 0.4 * np.sin(6 * (y[..., None] + x[..., None]) + ph)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, f"{i:04d}.png"))


def _downscale(src, dst, s):
    os.makedirs(dst)
    for name in sorted(os.listdir(src)):
        im = Image.open(os.path.join(src, name))
        im.resize((im.width // s, im.height // s), Image.BICUBIC).save(
            os.path.join(dst, name))


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """HR PNGs, their x4 LR, the three test configs with their paths
    rewritten, the tiny models' checkpoints and a random LPIPS file."""
    root = tmp_path_factory.mktemp("eval")
    hr = str(root / "hr")
    _write_pngs(hr, [(64, 48), (48, 64)], 0)
    _downscale(hr, str(root / "lr"), 4)
    cfgs = {}
    for name in ("test-benchmark-4", "test-fast-div2k-4", "test-ood-div2k-8"):
        with open(os.path.join(CONFIGS, "test", name + ".yaml")) as f:
            cfg = yaml.safe_load(f)
        args = cfg["test_dataset"]["dataset"]["args"]
        if "root_path" in args:
            args["root_path"] = hr
        else:
            args["root_path_1"], args["root_path_2"] = str(root / "lr"), hr
        cfgs[name] = str(root / f"{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(cfg, f)
    model, prior = build_flagship("cpu", seed=0, tiny=True)
    pmodel, pprior = build_linf_patch("cpu", seed=0, tiny=True)
    paths = {}
    for tag, m, p in (("", model, prior), ("patch_", pmodel, pprior)):
        paths[tag + "model"] = str(root / f"{tag}linf.ckpt")
        paths[tag + "prior"] = str(root / f"{tag}prior.ckpt")
        ckpt.save_checkpoint(paths[tag + "model"],
                             {"model": {**m.spec(), "sd": m.state_dict()}})
        ckpt.save_checkpoint(paths[tag + "prior"],
                             {"prior_model": {**p.spec(),
                                              "sd": p.state_dict()}})
    paths["lpips"] = str(root / "lpips.pth")
    torch.save(LPIPS(seed=1).state_dict(), paths["lpips"])
    return root, cfgs, paths, (model, prior)


def _run(cfg, paths, *flags, prior=True, patch=False):
    tag = "patch_" if patch else ""
    argv = ["--config", cfg, "--model", paths[tag + "model"], "--device",
            "cpu", *flags]
    if prior:
        argv += ["--prior_model", paths[tag + "prior"]]
    return test_cli.main(argv)


@pytest.mark.parametrize("name", ["test-benchmark-4", "test-fast-div2k-4",
                                  "test-ood-div2k-8"])
def test_test_cli_runs_the_shipped_configs(eval_tree, monkeypatch, capsys,
                                           name):
    root, cfgs, paths, (model, prior) = eval_tree
    monkeypatch.chdir(root)
    got = _run(cfgs[name], paths, "--warmup")
    out = capsys.readouterr().out
    assert f"psnr: {got:.3f}" in out and "warmup: LR" in out
    assert np.isfinite(got) and got > 10
    # the CLI is eval_psnr over the config's wrapper on the loaded models
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.data.wrappers import batches

    with open(cfgs[name]) as f:
        cfg = yaml.safe_load(f)
    spec = cfg["test_dataset"]
    data = registry.make({"name": spec["wrapper"]["name"], "args": {
        **spec["wrapper"]["args"], "dataset": registry.make(spec["dataset"])}})
    assert got == pytest.approx(eval_psnr(
        batches(data), model, prior, data_norm=cfg["data_norm"],
        eval_type=cfg["eval_type"], log_fn=lambda *_: None), abs=1e-9)


def test_test_cli_flags(eval_tree, monkeypatch, capsys):
    root, cfgs, paths, _ = eval_tree
    monkeypatch.chdir(root)
    div2k = cfgs["test-fast-div2k-4"]
    # --detail without LPIPS weights is refused before any model loads
    with pytest.raises(SystemExit, match="--no_lpips"):
        test_cli.main(["--config", div2k, "--model", "missing.ckpt",
                       "--detail", "--device", "cpu"])
    res = _run(div2k, paths, "--detail", "--lpips_weights", paths["lpips"])
    assert set(res) == {"psnr", "ssim", "lpips", "LR recon"}
    assert all(np.isfinite(v) for v in res.values())
    assert "lpips: " in capsys.readouterr().out
    res = _run(div2k, paths, "--detail", "--no_lpips", "--randomness",
               "--temperature", "0.8", prior=False)
    assert res["diversity"] > 0 and np.isnan(res["lpips"])
    _run(div2k, paths, "--sample", "1", "--name", "run", "--name_sub", "a",
         "--limit", "1")
    assert os.listdir(root / "sample" / "run" / "a") == ["801x4.png"]
    assert np.isfinite(_run(div2k, paths, "--window", "8"))
    assert np.isfinite(_run(div2k, paths, "--pad_multiple", "8",
                            "--warmup"))
    for name in ("test-benchmark-4", "test-fast-div2k-4"):
        assert np.isfinite(_run(cfgs[name], paths, "--patch", patch=True))
    with pytest.raises(ValueError, match="patch"):
        _run(div2k, paths, "--patch", "--window", "8", patch=True)


def test_srflow_test_cli(tmp_path, monkeypatch, capsys):
    from bfsr_tpu_torch.entry import build_srflow_lp

    hr = str(tmp_path / "hr")
    _write_pngs(hr, [(64, 48), (48, 64)], 3)
    _downscale(hr, str(tmp_path / "lr"), 4)
    model, prior = build_srflow_lp("cpu", seed=0, tiny=True)
    torch.save(model.state_dict(), tmp_path / "srflow.pth")
    torch.save(prior.state_dict(), tmp_path / "prior.pth")
    torch.save(LPIPS(seed=1).state_dict(), tmp_path / "lpips.pth")
    a = model.args
    conf = {"name": "SRFlow-LP", "scale": 4,
            "dataroot_LR": str(tmp_path / "lr"),
            "dataroot_GT": hr, "model_path": str(tmp_path / "srflow.pth"),
            "prior_model_path": str(tmp_path / "prior.pth"),
            "prior_model": {"name": "unet", "args": prior.args},
            "network_G": {"in_nc": 3, "out_nc": 3, "nf": a["nf"],
                          "nb": a["nb"], "gc": a["gc"], "flow": {
                              "K": a["K"], "L": a["L"],
                              "hidden_channels": a["hidden_channels"],
                              "additionalFlowNoAffine": a["additional_steps"],
                              "split": {"enable": a["split_enable"]},
                              "fea_up0": a["fea_up0"],
                              "stackRRDB": {"blocks": list(a["stack_blocks"]),
                                            "concat": a["stack_concat"]}}}}
    path = tmp_path / "conf.yml"
    path.write_text(yaml.safe_dump(conf))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--no_lpips"):
        srflow_cli.main([str(path), "--device", "cpu"])
    rows = srflow_cli.main([str(path), "--device", "cpu", "--lpips_weights",
                            str(tmp_path / "lpips.pth"), "--warmup",
                            "--pad_multiple", "4"])
    out = capsys.readouterr().out
    assert "Mean: PSNR: " in out and "warmup: LR 12x16" in out
    with open(tmp_path / "results" / "SRFlow-LP" / "measure_full.csv") as f:
        table = list(csv.DictReader(f))
    assert len(table) == 2 and list(table[0]) == list(srflow_cli.FIELDS)
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("PSNR", "SSIM", "LPIPS", "LRC PSNR"))
    # the first row is the predictor's on the same weights
    lr = np.asarray(Image.open(tmp_path / "lr" / "0000.png").convert("RGB"))
    sr = SRFlowLPPredictor(model, prior, pad_multiple=4).predict(
        lr.astype(np.float32) / 255.0)
    sr = np.round(sr.numpy() * 255.0).astype(np.uint8)
    want = psnr_uint8(sr, np.asarray(Image.open(os.path.join(hr, "0000.png"))))
    assert rows[0]["PSNR"] == pytest.approx(want, abs=1e-9)
    conf["dataroot_LR"] = str(tmp_path / "empty")
    path.write_text(yaml.safe_dump(conf))
    with pytest.raises(SystemExit, match="no .png images"):
        srflow_cli.main([str(path), "--device", "cpu", "--no_lpips"])


def test_train_cli_validates_every_epoch_val(tmp_path, monkeypatch, capsys):
    from bfsr_tpu_torch.cli import train as cli

    from test_torch_train_data import _config
    from test_torch_train_data import _write_pngs as write_train_pngs

    root = str(tmp_path / "imgs")
    write_train_pngs(root, n=2)
    cfg = _config(root, 2)
    cfg["val_dataset"] = {
        "dataset": {"name": "image-folder",
                    "args": {"root_path": root, "repeat": 2,
                             "cache": "in_memory"}},
        "wrapper": {"name": "sr-implicit-downsampled-fast",
                    "args": {"inp_size": 8, "scale_max": 4}},
        "batch_size": 2}
    cfg["epoch_val"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    cli.cli(["--config", str(path), "--name", "run", "--allow_random_vgg",
             "--device", "cpu"])
    log = (tmp_path / "save" / "run" / "log.txt").read_text()
    vals = [float(line.split("val: psnr=")[1].split(",")[0])
            for line in log.splitlines() if "val: psnr=" in line]
    assert len(vals) == 2 and all(np.isfinite(v) for v in vals)
    # the patch model trains with the shipped config's val_dataset, and
    # skips its validation with a warning
    cfg["train_dataset"]["wrapper"]["args"] = {"inp_size": 8,
                                               "scale_max": 2}
    cfg["epoch_max"] = 1
    path.write_text(yaml.safe_dump(cfg))
    cli.cli(["--config", str(path), "--name", "p", "--patch", "3",
             "--allow_random_vgg", "--device", "cpu"])
    log = (tmp_path / "save" / "p" / "log.txt").read_text()
    assert "WARNING: validation of the patch model" in log
    assert "ROADMAP.md queue 3" in log
    assert "epoch 1/1" in log and "val: psnr=" not in log
