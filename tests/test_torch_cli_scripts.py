"""The port's twins of the three root scripts (``bfsr_tpu_torch/cli/
prepare_data.py``, ``convert_checkpoint.py``, ``selfcheck.py``):

* ``prepare_data`` on a folder of 3 PNGs against the JAX script on a copy
  of it, the same seed: every pickle's crops equal (HR and the
  MATLAB-bicubic LQ: the port's ``imresize`` is the JAX one bit for bit,
  ``tests/test_torch_eval.py``), and ``lrhr-pkl`` reads the port's;
* ``convert_checkpoint`` of each kind from a reference-keyed ``.pth``
  made from a random port model: the converted file loads, through the
  loader its users call, to the tensors that the ``.pth`` loads to;
* ``selfcheck --device cpu`` passes, and with no card and no ``--device
  cpu`` it raises.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu_torch.data.pkl_dataset  # noqa: F401  (registers lrhr-pkl)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.cli import convert_checkpoint, prepare_data, selfcheck
from bfsr_tpu_torch.entry import flagship_specs, srflow_specs
from bfsr_tpu_torch.models.lpips import LPIPS, load_lpips

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NAMES = ("HR.pklv4", "HR_X4.pklv4", "HR_1pct.pklv4", "HR_X4_1pct.pklv4")


def _pickles(root):
    out = {}
    for name in NAMES:
        with open(root / "pkls" / name, "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_prepare_data_matches_jax(tmp_path):
    import prepare_data as j_prepare

    rng = np.random.default_rng(0)
    for side in ("port", "jax"):
        (tmp_path / side / "HR").mkdir(parents=True)
    for i, hw in enumerate(((200, 210), (190, 230), (240, 200))):
        img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "port" / "HR" / f"{i}.png")
    shutil.copytree(tmp_path / "port" / "HR", tmp_path / "jax" / "HR",
                    dirs_exist_ok=True)
    kw = {"crops_per_image": 34, "crop_size": 160, "scale": 4, "seed": 3}
    prepare_data.main(str(tmp_path / "port" / "HR"), **kw)
    j_prepare.main(str(tmp_path / "jax" / "HR"), **kw)
    got, ref = _pickles(tmp_path / "port"), _pickles(tmp_path / "jax")
    assert len(got["HR.pklv4"]) == 102 and len(got["HR_1pct.pklv4"]) == 1
    for name in NAMES:
        assert len(got[name]) == len(ref[name]), name
        for a, b in zip(got[name], ref[name]):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got["HR_X4.pklv4"][0].shape == (40, 40, 3)

    ds = registry.make({"name": "lrhr-pkl", "args": {
        "dataroot_GT": str(tmp_path / "port" / "pkls" / "HR.pklv4"),
        "dataroot_LQ": str(tmp_path / "port" / "pkls" / "HR_X4.pklv4"),
        "gt_size": 96}})
    assert len(ds) == 102 and ds[0]["LQ"].shape == (24, 24, 3)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _convert(tmp_path, src, *args):
    dst = str(tmp_path / "out.ckpt")
    convert_checkpoint.main([str(src), dst, *args])
    return dst


def _random(spec, seed):
    m = registry.make(spec)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return m


@pytest.mark.parametrize("kind", ["auto", "linf"])
def test_convert_linf(tmp_path, kind):
    from bfsr_tpu_torch.convert.load import load_linf_model

    spec, _ = flagship_specs(tiny=True)
    m = _random(spec, 1)
    pth = tmp_path / "linf.pth"
    torch.save({"model": {**spec, "sd": m.state_dict()}}, pth)
    out = _convert(tmp_path, pth, "--kind", kind)
    _same(load_linf_model(out, device="cpu").state_dict(),
          load_linf_model(str(pth), device="cpu").state_dict())


@pytest.mark.parametrize("which", ["unet", "srflow-unet"])
def test_convert_prior(tmp_path, which):
    """The reference names both UNets ``unet``; the two-branch one is told
    by its keys."""
    from bfsr_tpu_torch.convert.load import load_prior_model

    spec = (flagship_specs(tiny=True)[1] if which == "unet"
            else srflow_specs(tiny=True)[1])
    m = _random(spec, 2)
    pth = tmp_path / "prior.pth"
    torch.save({"prior_model": {"name": "unet", "args": spec["args"],
                                "sd": m.state_dict()}}, pth)
    out = _convert(tmp_path, pth)
    loaded = load_prior_model(out, device="cpu")
    assert loaded.registry_name == which
    _same(loaded.state_dict(),
          load_prior_model(str(pth), device="cpu").state_dict())


def test_convert_srflow(tmp_path):
    from bfsr_tpu_torch.cli.srflow_train import load_srflow

    spec, _ = srflow_specs(tiny=True)
    a = spec["args"]
    conf = tmp_path / "conf.yml"
    conf.write_text(yaml.safe_dump({"scale": 4, "network_G": {
        "nf": a["nf"], "nb": a["nb"], "gc": a["gc"], "flow": {
            "K": a["K"], "L": a["L"], "hidden_channels": a["hidden_channels"],
            "split": {"enable": True}, "fea_up0": True,
            "stackRRDB": {"blocks": list(a["stack_blocks"]),
                          "concat": True}}}}))
    m = _random(spec, 3)
    pth = tmp_path / "srflow.pth"
    # the reference's file: a DataParallel state_dict
    torch.save({f"module.{k}": v for k, v in m.state_dict().items()}, pth)
    out = _convert(tmp_path, pth, "--kind", "srflow", "--conf", str(conf))
    opt = yaml.safe_load(conf.read_text())
    _same(load_srflow(dict(opt, model_path=out), "cpu").state_dict(),
          load_srflow(dict(opt, model_path=str(pth)), "cpu").state_dict())
    _same(load_srflow(dict(opt, model_path=out), "cpu").state_dict(),
          m.state_dict())


def test_convert_vgg(tmp_path):
    from bfsr_tpu_torch.cli.train import load_vgg

    vgg = _random({"name": "VGGFeatureExtractor", "args": {}}, 4)
    pth = tmp_path / "vgg19.pth"
    torch.save({k: v for k, v in vgg.state_dict().items()
                if k.startswith("features.")}, pth)
    out = _convert(tmp_path, pth, "--kind", "vgg")
    _same(load_vgg({"vgg_weights": out}, "cpu").state_dict(),
          load_vgg({"vgg_weights": str(pth)}, "cpu").state_dict())


def test_convert_lpips(tmp_path):
    pth = tmp_path / "lpips_alex.pth"
    torch.save(LPIPS(seed=5).state_dict(), pth)
    out = _convert(tmp_path, pth, "--kind", "lpips")
    _same(load_lpips(out, "cpu").state_dict(),
          load_lpips(str(pth), "cpu").state_dict())


def test_convert_refuses_what_it_cannot_tell(tmp_path):
    pth = tmp_path / "bare.pth"
    torch.save({"conv.weight": torch.zeros(1)}, pth)
    with pytest.raises(SystemExit, match="--kind"):
        _convert(tmp_path, pth)
    with pytest.raises(SystemExit, match="--conf"):
        _convert(tmp_path, pth, "--kind", "srflow")


def test_selfcheck_cpu(capsys):
    selfcheck.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "roundtrip: OK" in out and "selfcheck passed" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_selfcheck_without_a_card_raises():
    with pytest.raises(RuntimeError, match="--device cpu"):
        selfcheck.main([])
