"""The LINF-LP trainer's host side, on the CPU: the crop wrapper against
the JAX package's under the same ``random.seed``, the loader, checkpoint
save / load / resume, and the trainer CLI for an epoch on four PNGs and
its resume."""

import os
import random

import numpy as np
import pytest
import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.data.loader import DataLoader
from bfsr_tpu_torch.entry import flagship_specs
from bfsr_tpu_torch.pipelines.linf_train import make_train_step
from bfsr_tpu_torch.train import checkpoints as ckpt
from bfsr_tpu_torch.train.optim import lr_scheduler, make_optimizer, \
    multi_step_lr

import bfsr_tpu_torch.data.wrappers  # noqa: F401  (registers)
import bfsr_tpu_torch.models  # noqa: F401  (registers)

CROP_KEYS = ("inp", "coord", "cell", "gt", "gt_lr_up", "gt_pixel")


@pytest.mark.parametrize("augment", [False, True])
def test_crop_wrapper_matches_jax(augment):
    pytest.importorskip("PIL")
    from bfsr_tpu.data import wrappers as jwrappers

    img = np.random.default_rng(0).random((70, 66, 3)).astype(np.float32)
    args = {"inp_size": 12, "scale_max": 4, "augment": augment}
    ours = registry.make({"name": "sr-implicit-downsampled-fast-crop",
                          "args": {"dataset": [img], **args}})
    theirs = jwrappers.SRImplicitDownsampledFastCrop([img], **args)
    for seed in range(3):
        random.seed(seed)
        got = ours[0]
        random.seed(seed)
        want = theirs[0]
        assert set(got) == set(CROP_KEYS) == set(want)
        for k in CROP_KEYS:
            assert got[k].dtype == np.float32, k
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_loader_batches_in_order_and_shuffles_by_seed():
    data = [{"x": np.full((2,), i, np.float32)} for i in range(11)]
    plain = [b["x"][:, 0].tolist() for b in DataLoader(data, batch_size=4)]
    assert plain == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
    runs = [[int(v) for b in DataLoader(data, 3, shuffle=True, seed=5,
                                        drop_last=True) for v in b["x"][:, 0]]
            for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 9
    assert runs[0] != list(range(9))


def test_loader_raises_a_worker_error_in_the_consumer():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("bad sample")
            return {"x": np.zeros(1)}

    with pytest.raises(KeyError):
        list(DataLoader(Bad(), batch_size=1, num_workers=2))


def _tiny_trainer():
    from bfsr_tpu_torch.entry import build_flagship_trainer

    return build_flagship_trainer("cpu", seed=0, tiny=True)


def _batch(seed):
    from bfsr_tpu_torch.entry import example_train_batch

    return example_train_batch("cpu", seed, batch=2, inp_size=8)


def test_checkpoint_save_load_resume(tmp_path):
    """A resumed prior, optimizer and schedule take the next step exactly
    as the run that saved them."""
    linf, prior, vgg = _tiny_trainer()
    spec = {"name": "adam", "args": {"lr": 1e-3}}

    def run(prior, count=0):
        opt = make_optimizer(spec, prior.parameters())
        sched = lr_scheduler(opt, multi_step_lr(1e-3, [2], 0.5), 1e-3, count)
        return opt, make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                                    scheduler=sched)

    opt, step = run(prior)
    for seed in range(2):
        step(_batch(seed))
    path = str(tmp_path / "prior_model-epoch-last.ckpt")
    ckpt.save_checkpoint(path, ckpt.train_state(prior, opt, spec, epoch=1))
    assert ckpt.find_auto_resume(str(tmp_path)) == path
    assert ckpt.find_auto_resume(str(tmp_path / "none")) is None

    sv = ckpt.load_checkpoint(path)
    assert sv["epoch"] == 1 and sv["optimizer"]["name"] == "adam"
    prior2 = registry.make(sv["prior_model"])
    prior2.load_state_dict(sv["prior_model"]["sd"])
    opt2, step2 = run(prior2.train(), count=2)
    opt2.load_state_dict(sv["optimizer"]["sd"])
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == 5e-4
    a, b = step(_batch(7)), step2(_batch(7))
    assert a == b
    for (k, v), v2 in zip(prior.state_dict().items(),
                          prior2.state_dict().values()):
        assert torch.equal(v, v2), k


def _write_pngs(root, n=4, size=64):
    from PIL import Image

    os.makedirs(root)
    rng = np.random.default_rng(1)
    for i in range(n):
        img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"{i:04d}.png"))


def _config(root, epoch_max):
    linf_spec, _ = flagship_specs(tiny=True)
    return {
        "train_dataset": {
            "dataset": {"name": "image-folder",
                        "args": {"root_path": root, "cache": "in_memory"}},
            "wrapper": {"name": "sr-implicit-downsampled-fast",
                        "args": {"inp_size": 16, "scale_max": 4,
                                 "augment": True}},
            "batch_size": 2},
        "data_norm": {"inp": {"sub": [0.5], "div": [0.5]},
                      "gt": {"sub": [0.5], "div": [0.5]}},
        "model": linf_spec,
        "optimizer": {"name": "adam", "args": {"lr": 1e-4}},
        "prior_model": {"name": "unet", "args": {"in_chans": 3, "depth": 2,
                                                 "dim": 8, "bilinear": True}},
        "epoch_max": epoch_max,
        "multi_step_lr": {"milestones": [1], "gamma": 0.5},
        "loss_weight": {"vgg": 1.0, "latent": 0.5},
        "epoch_save": 1,
    }


def test_cli_trains_an_epoch_and_resumes(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    yaml = pytest.importorskip("yaml")
    from bfsr_tpu_torch.cli import train as cli

    root = str(tmp_path / "imgs")
    _write_pngs(root)
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config(root, 1)))
    args = ["--config", str(cfg), "--name", "run", "--allow_random_vgg",
            "--device", "cpu"]
    cli.cli(args)
    save = tmp_path / "save" / "run"
    last = save / "prior_model-epoch-last.ckpt"
    assert last.exists() and (save / "prior_model-epoch-1.ckpt").exists()
    sv = ckpt.load_checkpoint(str(last))
    assert sv["epoch"] == 1
    assert sv["prior_model"]["name"] == "unet"
    # two iterations of the one epoch: the milestone at epoch 1 is step 2
    assert sv["optimizer"]["sd"]["state"][0]["step"] == 2

    conf = _config(root, 2)
    conf["resume_prior_model"] = str(last)
    cfg.write_text(yaml.safe_dump(conf))
    cli.cli(args)
    sv = ckpt.load_checkpoint(str(last))
    assert sv["epoch"] == 2
    assert sv["optimizer"]["sd"]["state"][0]["step"] == 4
    assert sv["optimizer"]["sd"]["param_groups"][0]["lr"] == 5e-5
    log = (save / "log.txt").read_text()
    assert "resume training from epoch 2" in log
    assert "epoch 2/2" in log


@pytest.mark.parametrize("argv,loader,msg", [
    (["--patch", "2"], None, "odd integer > 1"),
    ([], "grain", "grain loader is not ported"),
])
def test_cli_refuses_the_later_slices(tmp_path, capsys, monkeypatch, argv,
                                      loader, msg):
    """An even patch size is refused, as ``train.py`` refuses it.  The
    grain loader, which the multi-GPU slice ported, is no longer refused:
    ``loader: grain`` trains an epoch on ``ShardedLoader`` (one shard
    without a process group), and the old refusal ``msg`` is gone."""
    from bfsr_tpu_torch.cli import train as cli

    cfg = tmp_path / "none.yaml"
    if loader:
        pytest.importorskip("PIL")
        yaml = pytest.importorskip("yaml")
        _write_pngs(str(tmp_path / "imgs"))
        conf = _config(str(tmp_path / "imgs"), 1)
        conf["train_dataset"]["loader"] = loader
        cfg.write_text(yaml.safe_dump(conf))
        monkeypatch.chdir(tmp_path)
        cli.cli(["--config", str(cfg), "--device", "cpu", "--name", "grain",
                 "--allow_random_vgg", *argv])
        log = (tmp_path / "save" / "grain" / "log.txt").read_text()
        assert "epoch 1/1" in log
        assert msg not in capsys.readouterr().err + log
        return
    with pytest.raises(SystemExit) as e:
        cli.cli(["--config", str(cfg), "--device", "cpu", *argv])
    assert msg in capsys.readouterr().err + str(e.value.code)
