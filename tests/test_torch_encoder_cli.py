"""The other encoders and latent modules through the port's entry points,
on the CPU, on PNGs, YAML and checkpoints the tests write:
``image-folder-DF2K`` against the JAX dataset; ``cli/train.py`` on
``configs/train/train_rrdb-linf-LP.yaml`` (its folders pointed at a DF2K
pair of written folders, at a tiny RRDB); a Swin and an EDSR latent
module trained, saved and resumed by the CLI; every new model read by
``convert/load.py`` from a JAX ``.ckpt``, a port ``.ckpt`` and a
reference ``.pth``; and ``cli/test.py`` on an RRDB-, a SwinIR- (``--window
8``) and an RDN-encoder LINF and on each latent module."""

import os

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)
from bfsr_tpu import registry as jregistry
from bfsr_tpu.data.image_folder import ImageFolderDF2K as JDF2K
from bfsr_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.cli import test as test_cli
from bfsr_tpu_torch.cli import train as train_cli
from bfsr_tpu_torch.convert.load import load_linf_model, load_prior_model
from bfsr_tpu_torch.data.image_folder import ImageFolderDF2K
from bfsr_tpu_torch.entry import flagship_specs
from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr
from bfsr_tpu_torch.train import checkpoints as ckpt

yaml = pytest.importorskip("yaml")
Image = pytest.importorskip("PIL.Image")
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _write_pngs(root, n, hw, seed, prefix=""):
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        y, x = np.mgrid[:hw[0], :hw[1]] / max(hw)
        img = 0.5 + 0.4 * np.sin(6 * (y[..., None] + x[..., None])
                                 + rng.random(3) * 6)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, f"{prefix}{i:04d}.png"))


@pytest.fixture(scope="module")
def df2k(tmp_path_factory):
    root = tmp_path_factory.mktemp("df2k")
    _write_pngs(str(root / "DIV2K_train_HR"), 3, (72, 68), 0)
    _write_pngs(str(root / "Flickr2K_HR"), 4, (68, 76), 1, "f")
    return str(root / "DIV2K_train_HR"), str(root / "Flickr2K_HR")


@pytest.mark.parametrize("cache", ["none", "in_memory", "bin"])
@pytest.mark.parametrize("first_k,repeat", [(None, 1), (2, 3)])
def test_df2k_matches_the_jax_dataset(df2k, cache, first_k, repeat):
    """DIV2K (cached per ``cache``) then Flickr2K (decoded lazily), each
    cut to ``first_k``: the JAX dataset's order, length and arrays."""
    args = dict(root_path_D2K=df2k[0], root_path_F2K=df2k[1],
                first_k=first_k, repeat=repeat, cache=cache)
    ours, ref = ImageFolderDF2K(**args), JDF2K(**args)
    n = (min(3, first_k or 3) + min(4, first_k or 4)) * repeat
    assert len(ours) == len(ref) == n
    for i in range(n):
        np.testing.assert_array_equal(ours[i], ref[i])
    n_div = min(3, first_k or 3)
    assert all(isinstance(f, str) and f.endswith(".png")
               for f in ours.files[n_div:])


def _rrdb_config(df2k, tmp_path):
    """``train_rrdb-linf-LP.yaml`` as shipped, its folders pointed at the
    written DF2K pair and its resume path at none, with the RRDB and the
    rest cut to the CPU's size (nf 8, nb 2, gc 4; flow L 3, MLP 32; UNet
    depth 2 / dim 8; B 2 of 16^2; one epoch)."""
    with open(os.path.join(CONFIGS, "train", "train_rrdb-linf-LP.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["train_dataset"]["dataset"]["name"] == "image-folder-DF2K"
    assert cfg["model"]["args"]["encoder_spec"]["name"] == "rrdb"
    ds = cfg["train_dataset"]["dataset"]["args"]
    ds["root_path_D2K"], ds["root_path_F2K"] = df2k
    ds["repeat"] = 1
    cfg["val_dataset"]["dataset"]["args"]["root_path"] = df2k[0]
    cfg["resume"] = str(tmp_path / "none.pth")
    cfg["model"]["args"]["encoder_spec"]["args"].update(nf=8, nb=2, gc=4)
    cfg["model"]["args"].update(flow_layers=3, num_layer=2, hidden_dim=32)
    cfg["prior_model"]["args"].update(depth=2, dim=8)
    cfg["train_dataset"]["wrapper"]["args"]["inp_size"] = 16
    cfg["train_dataset"]["batch_size"] = 2
    cfg["epoch_max"] = 1
    return cfg


def _train(cfg, tmp_path, name, *flags):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_cli.cli(["--config", str(path), "--name", name,
                   "--allow_random_vgg", "--device", "cpu", *flags])
    return (tmp_path / "save" / name / "log.txt").read_text()


def test_train_cli_runs_the_rrdb_config_on_df2k(df2k, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _rrdb_config(df2k, tmp_path)
    log = _train(cfg, tmp_path, "rrdb")
    assert "train dataset: size=7" in log and "epoch 1/1" in log
    saved = ckpt.load_checkpoint(
        str(tmp_path / "save" / "rrdb" / "prior_model-epoch-last.ckpt"))
    assert saved["epoch"] == 1 and saved["prior_model"]["name"] == "unet"
    # and it resumes from that epoch
    cfg["resume_prior_model"] = str(tmp_path / "save" / "rrdb" /
                                    "prior_model-epoch-last.ckpt")
    cfg["epoch_max"] = 2
    log = _train(cfg, tmp_path, "rrdb2")
    assert "resume training from epoch 2" in log and "epoch 2/2" in log


@pytest.mark.parametrize("prior", ["swin_latent", "edsr-baseline-latent"])
def test_train_cli_trains_saves_and_resumes_a_latent_module(
        df2k, tmp_path, monkeypatch, prior):
    monkeypatch.chdir(tmp_path)
    cfg = _rrdb_config(df2k, tmp_path)
    cfg["model"] = flagship_specs(tiny=True)[0]
    cfg["prior_model"] = {"name": prior, "args": {"in_chans": 3}}
    if prior == "edsr-baseline-latent":
        cfg["prior_model"]["args"]["n_resblocks"] = 2
    log = _train(cfg, tmp_path, "p")
    assert "epoch 1/1" in log
    last = str(tmp_path / "save" / "p" / "prior_model-epoch-last.ckpt")
    trained = load_prior_model(last, "cpu")
    assert trained.registry_name == prior
    fresh = registry.make(cfg["prior_model"])
    assert any(not torch.equal(a, b) for a, b in
               zip(trained.state_dict().values(),
                   fresh.state_dict().values()))
    cfg["resume_prior_model"], cfg["epoch_max"] = last, 2
    log = _train(cfg, tmp_path, "p2")
    assert "resume training from epoch 2" in log and "epoch 2/2" in log


def _linf_spec(name, args):
    spec = flagship_specs(tiny=True)[0]
    spec["args"]["encoder_spec"] = {"name": name, "args": args}
    return spec


MODELS = {
    "rrdb": _linf_spec("rrdb", {"nf": 8, "nb": 2, "gc": 4,
                                "no_upsampling": True}),
    "swinir": _linf_spec("swinir", {"embed_dim": 16, "depths": [1, 1],
                                    "num_heads": [2, 2], "window_size": 8,
                                    "num_feat": 8, "no_upsampling": True}),
    "rdn": _linf_spec("rdn", {"G0": 8, "RDNconfig": "A",
                              "no_upsampling": True}),
    "swin_latent": {"name": "swin_latent", "args": {"in_chans": 3}},
    "edsr-baseline-latent": {"name": "edsr-baseline-latent",
                             "args": {"in_chans": 3, "n_resblocks": 2}},
}


def _three_formats(tmp_path, name):
    """The JAX model of MODELS[name] saved as a JAX ``.ckpt``; loaded from
    it, saved as a port ``.ckpt`` and a reference ``.pth``: the paths."""
    spec = MODELS[name]
    jm = jregistry.make(spec)
    key = "model" if spec["name"] == "linf" else "prior_model"
    load = load_linf_model if key == "model" else load_prior_model
    paths = {f: str(tmp_path / f"{name}.{f}") for f in
             ("jax.ckpt", "port.ckpt", "ref.pth")}
    j_save_checkpoint(paths["jax.ckpt"], {key: {
        **spec, "params": jax.tree_util.tree_map(np.asarray, jm.params)}})
    m = load(paths["jax.ckpt"], device="cpu")
    ckpt.save_checkpoint(paths["port.ckpt"],
                         {key: {**m.spec(), "sd": m.state_dict()}})
    torch.save({key: {**spec, "sd": m.state_dict()}}, paths["ref.pth"])
    for f in ("port.ckpt", "ref.pth"):
        other = load(paths[f], device="cpu")
        assert set(other.state_dict()) == set(m.state_dict())
        for k, v in m.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), (f, k)
    return paths, m


@pytest.fixture(scope="module")
def eval_files(tmp_path_factory):
    """HR PNGs, their x4 LR, test-fast-div2k-4 with its paths rewritten."""
    root = tmp_path_factory.mktemp("eval")
    _write_pngs(str(root / "hr"), 2, (48, 64), 2)
    os.makedirs(root / "lr")
    for f in sorted(os.listdir(root / "hr")):
        im = Image.open(root / "hr" / f)
        im.resize((im.width // 4, im.height // 4), Image.BICUBIC).save(
            root / "lr" / f)
    with open(os.path.join(CONFIGS, "test", "test-fast-div2k-4.yaml")) as f:
        cfg = yaml.safe_load(f)
    args = cfg["test_dataset"]["dataset"]["args"]
    args["root_path_1"], args["root_path_2"] = str(root / "lr"), str(
        root / "hr")
    path = root / "test.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


@pytest.mark.parametrize("name", sorted(MODELS))
def test_test_cli_runs_each_model_from_a_jax_checkpoint(
        eval_files, tmp_path, monkeypatch, capsys, name):
    """``cli/test.py`` on each new encoder's LINF (SwinIR with ``--window
    8``: its padded map queried on the padded grid, then cropped) and on
    each latent module as the tiny flagship's prior, read from a JAX
    ``.ckpt``; the PSNR it prints is ``eval_psnr``'s on the models that
    ``convert/load.py`` reads from all three formats alike."""
    cfg_path, cfg = eval_files
    monkeypatch.chdir(tmp_path)
    paths, m = _three_formats(tmp_path, name)
    argv = ["--config", cfg_path, "--device", "cpu"]
    window = 8 if name == "swinir" else 0
    if name in ("swin_latent", "edsr-baseline-latent"):
        linf = _three_formats(tmp_path, "rrdb")[1]
        lpath = str(tmp_path / "linf.ckpt")
        ckpt.save_checkpoint(lpath, {"model": {**linf.spec(),
                                               "sd": linf.state_dict()}})
        argv += ["--model", lpath, "--prior_model", paths["jax.ckpt"]]
        prior = m
    else:
        argv += ["--model", paths["jax.ckpt"], "--window", str(window)]
        linf, prior = m, None
    got = test_cli.main(argv)
    assert f"psnr: {got:.3f}" in capsys.readouterr().out
    assert np.isfinite(got)
    from bfsr_tpu_torch.data.wrappers import batches

    spec = cfg["test_dataset"]
    ds = registry.make({"name": spec["wrapper"]["name"], "args": {
        "dataset": registry.make(spec["dataset"])}})
    want = eval_psnr(batches(ds), linf, prior,
                     data_norm=cfg["data_norm"], eval_type=cfg["eval_type"],
                     window_size=window)
    assert got == pytest.approx(want, abs=1e-6)
