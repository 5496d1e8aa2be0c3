"""The SRFlow training CLI's base trainer and plain-SR trainer
(``bfsr_tpu_torch/cli/srflow_train.py``, the ``srflow_train.py`` twin) on
a tiny conf and ``lrhr-pkl`` pickles the test writes (RRDB nf 8, nb 2, gc
4; K 2, L 3, hidden 8; B 2 of 32^2 GT), on the CPU: the RRDB stays as
``pretrain_model_G`` gave it while frozen and trains after
``train_RRDB_delay * niter``, the checkpoints are written (two ``G_``
kept, ``G_latest``) and auto-resume goes on from the newest; ``model:
sr`` trains the x4 RRDB, whose checkpoint the base trainer then takes as
its pretrained RRDB; a JAX ``.ckpt`` of RRDB params loads too."""

import pickle

import numpy as np
import pytest
import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.cli import srflow_train as cli
from bfsr_tpu_torch.convert.from_jax import rrdb_state_dict
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.train import checkpoints as ckpt

from test_torch_precision import restore_modes  # noqa: F401  (fixture)

yaml = pytest.importorskip("yaml")


def _pickles(tmp_path):
    rng = np.random.default_rng(2)
    hrs = [(rng.random((32, 32, 3)) * 255).astype(np.uint8) for _ in range(6)]
    lqs = [(rng.random((8, 8, 3)) * 255).astype(np.uint8) for _ in range(6)]
    paths = {}
    for name, data in (("gt", hrs), ("lq", lqs)):
        paths[name] = str(tmp_path / f"{name}.pklv4")
        with open(paths[name], "wb") as f:
            pickle.dump(data, f)
    return paths


def _conf(tmp_path, name, **extra):
    paths = _pickles(tmp_path)
    conf = {
        "name": name, "scale": 4,
        "datasets": {"train": {"mode": "LRHR_PKL", "dataroot_GT": paths["gt"],
                               "dataroot_LQ": paths["lq"], "quant": 32,
                               "batch_size": 2, "n_workers": 1,
                               "use_flip": True}},
        "network_G": {"which_model_G": "SRFlowNet", "in_nc": 3, "out_nc": 3,
                      "nf": 8, "nb": 2, "gc": 4, "train_RRDB_delay": 0.5,
                      "flow": {"K": 2, "L": 3, "hidden_channels": 8,
                               "additionalFlowNoAffine": 2,
                               "split": {"enable": True}, "fea_up0": True,
                               "stackRRDB": {"blocks": [0, 1],
                                             "concat": True}}},
        "path": {"resume_state": "auto"},
        "train": {"lr_G": 1e-3, "beta1": 0.9, "beta2": 0.99,
                  "lr_scheme": "MultiStepLR", "lr_steps_rel": [0.5],
                  "lr_gamma": 0.5, "niter": 4, "weight_l1": 0.5},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 1}}
    conf.update(extra)
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(conf))
    return str(path)


def _rrdb(sd):
    return {k[len("RRDB."):]: v.clone() for k, v in sd.items()
            if k.startswith("RRDB.")}


def test_sr_then_base_trainer_freeze_train_save_resume(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    sr_conf = _conf(tmp_path, "sr_smoke", model="sr",
                    network_G={"which_model_G": "RRDBNet", "nf": 8, "nb": 2,
                               "gc": 4},
                    train={"lr_G": 1e-3, "niter": 2, "pixel_criterion": "cb"})
    cli.cli([sr_conf, "--device", "cpu"])
    sr_latest = tmp_path / "save" / "sr_smoke" / "G_latest.ckpt"
    sv = ckpt.load_checkpoint(str(sr_latest))
    assert sv["iter"] == 2 and sv["model"]["name"] == "rrdb"
    assert sv["model"]["args"]["no_upsampling"] is False
    assert "iter 1: loss=" in (tmp_path / "save" / "sr_smoke" /
                               "log.txt").read_text()
    pretrained = sv["model"]["sd"]

    saved = {}
    real_save = ckpt.save_checkpoint

    def spy(path, payload):
        saved[path.rsplit("/", 1)[-1]] = _rrdb(payload["model"]["sd"])
        real_save(path, payload)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    conf = _conf(tmp_path, "base_smoke",
                 path={"resume_state": "auto",
                       "pretrain_model_G": str(sr_latest)})
    cli.cli([conf, "--device", "cpu"])
    save = tmp_path / "save" / "base_smoke"
    log = (save / "log.txt").read_text()
    assert "loaded pretrained RRDB" in log and "priming actnorms" in log
    assert "iter 3: nll_loss=" in log and "l1_loss=" in log
    # unfreeze = int(0.5 * 4) = 2: steps 0 and 1 frozen (G_2 holds the
    # pretrained RRDB), step 2 trains it (G_3), its x4 head never moves
    assert set(saved) == {"G_2.ckpt", "G_3.ckpt", "G_4.ckpt",
                          "G_latest.ckpt"}
    for k, v in pretrained.items():
        assert torch.equal(saved["G_2.ckpt"][k], v), k
        moved = not torch.equal(saved["G_3.ckpt"][k], v)
        head = k.split(".")[0] in ("upconv2", "HRconv", "conv_last")
        assert moved != head, k
    assert sorted(p.name for p in save.glob("G_*")) == [
        "G_3.ckpt", "G_4.ckpt", "G_latest.ckpt"]
    sv = ckpt.load_checkpoint(str(save / "G_latest.ckpt"))
    assert sv["iter"] == 4 and sv["model"]["name"] == "srflow"
    model = registry.make(sv["model"])
    model.load_state_dict(sv["model"]["sd"])
    assert all(torch.isfinite(t.float()).all()
               for t in sv["model"]["sd"].values())
    # the flow's and the RRDB's Adam states share one count
    steps = {float(st["step"]) for st in sv["optimizer"]["sd"]["state"].values()}
    assert steps == {4.0}

    # auto-resume from G_latest (iter 4) on to 6
    cli.cli([conf, "--device", "cpu", "--niter", "6"])
    log = (save / "log.txt").read_text()
    assert "auto-resumed" in log and "iter 5: nll_loss=" in log
    assert ckpt.load_checkpoint(str(save / "G_latest.ckpt"))["iter"] == 6


def test_pretrain_model_g_reads_a_jax_checkpoint(tmp_path):
    """A JAX ``.ckpt`` (a pickle of numpy params) of an RRDB with its head
    loads as its reference-keyed state_dict."""
    import jax

    import bfsr_tpu.models  # noqa: F401  (registers)
    from bfsr_tpu import registry as jregistry

    jm = jregistry.make({"name": "rrdb", "args": {"nf": 8, "nb": 2, "gc": 4,
                                                  "no_upsampling": False}})
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    path = tmp_path / "rrdb.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": params}, f)
    got = cli.load_rrdb_weights(str(path))
    want = rrdb_state_dict(params)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_base_trainer_under_default(tmp_path, monkeypatch, restore_modes):
    """``--precision default`` sets the mode for the base trainer too: both
    phases run (the unfreeze at int(0.5 * 2) = 1) and save."""
    monkeypatch.chdir(tmp_path)
    conf = _conf(tmp_path, "base_default")
    cli.cli([conf, "--device", "cpu", "--niter", "2", "--precision",
             "default"])
    assert tnn.precision_mode() == "default"
    sv = ckpt.load_checkpoint(str(tmp_path / "save" / "base_default" /
                                  "G_latest.ckpt"))
    assert sv["iter"] == 2
    assert all(torch.isfinite(t.float()).all()
               for t in sv["model"]["sd"].values())
