"""Reference PyTorch checkpoints to the port's checkpoint files: the
counterpart of ``convert_checkpoint.py``, without jax.

    python -m bfsr_tpu_torch.cli.convert_checkpoint model.pth out.ckpt \\
        [--kind auto|linf|prior|srflow|vgg|lpips]
    # srflow also needs the flow config:
    python -m bfsr_tpu_torch.cli.convert_checkpoint SRFlow_DF2K_4X.pth \\
        out.ckpt --kind srflow --conf configs/srflow/SRFlow-LP_DF2K_4X.yml

Each kind is read by the port's own loader, which checks every key and
shape against the model it builds (a reference ``.pth``, a port ``.ckpt``
or a JAX ``.ckpt`` of numpy arrays), and written with
``train/checkpoints.save_checkpoint``:

* ``linf``: ``{'model': {name, args, sd}}`` (``convert/load.py:
  load_linf_model`` and the eval CLIs read it);
* ``prior``: ``{'prior_model': {name, args, sd}}`` (``load_prior_model``;
  the reference names SRFlow-LP's two-branch UNet ``unet`` too, and it is
  told by its keys);
* ``srflow``: ``{'model': {name, args, sd}}`` of the ``SRFlowNet`` that
  the conf's ``network_G`` builds (``cli/srflow_train.py:load_srflow``;
  ``cli/srflow_test.py`` reads it as ``model_path``);
* ``vgg``: the VGG19 feature extractor's ``state_dict`` (torchvision's
  ``features.{i}`` keys: ``cli/train.py``'s ``vgg_weights``);
* ``lpips``: the LPIPS-alex ``state_dict`` (the ``lpips`` package's keys:
  ``--lpips_weights``).

``auto`` reads the kind from the checkpoint's top-level key (``model``:
linf, ``prior_model``: prior).  The eval CLIs also read a reference
``.pth`` as it is; the converted file has been checked once and holds
the model's own ``state_dict`` and spec.
"""

import argparse
import os

import yaml

import bfsr_tpu_torch.models  # noqa: F401  (registers)
from bfsr_tpu_torch.train.checkpoints import save_checkpoint

KINDS = ("auto", "linf", "prior", "srflow", "vgg", "lpips")


def _spec_sd(model):
    return {**model.spec(), "sd": model.state_dict()}


def _vgg(src):
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.convert import from_jax
    from bfsr_tpu_torch.convert.load import read_checkpoint

    vgg = registry.make({"name": "VGGFeatureExtractor", "args": {}})
    kind, payload = read_checkpoint(src)
    if kind == "torch":
        want = [k for k in vgg.state_dict() if k.startswith("features.")]
        sd = payload.get("state_dict", payload)
        missing = [k for k in want if k not in sd]
        if missing:
            raise ValueError(f"{src}: not a VGG19 state_dict (missing "
                             f"{missing[:4]})")
        vgg.load_state_dict({k: sd[k] for k in want}, strict=False)
    else:
        from_jax.load_vgg(vgg, payload)
    return vgg.state_dict()


def convert(src, kind="auto", conf=None):
    """(the kind, the port checkpoint's payload) of the checkpoint at
    ``src``."""
    from bfsr_tpu_torch.convert.load import (load_linf_model,
                                             load_prior_model,
                                             read_checkpoint)

    if kind not in KINDS:
        raise ValueError(f"--kind {kind!r}: one of {KINDS}")
    if not os.path.isfile(src):
        raise SystemExit(f"{src}: no such checkpoint")
    if kind == "auto":
        _, ckpt = read_checkpoint(src)
        if isinstance(ckpt, dict) and "model" in ckpt:
            kind = "linf"
        elif isinstance(ckpt, dict) and "prior_model" in ckpt:
            kind = "prior"
        else:
            raise SystemExit("cannot tell the kind of this checkpoint (no "
                             "'model' or 'prior_model' key): pass --kind")
    if kind == "linf":
        model = load_linf_model(src, freeze=False, device="cpu")
        return kind, {"model": _spec_sd(model)}
    if kind == "prior":
        return kind, {"prior_model": _spec_sd(load_prior_model(src, "cpu"))}
    if kind == "srflow":
        from bfsr_tpu_torch.cli.srflow_train import load_srflow

        if not conf:
            raise SystemExit("--kind srflow needs --conf (the flow's conf "
                             "yml)")
        with open(conf) as f:
            opt = yaml.safe_load(f)
        return kind, {"model": _spec_sd(load_srflow(
            dict(opt, model_path=src), "cpu"))}
    if kind == "vgg":
        return kind, _vgg(src)
    from bfsr_tpu_torch.models.lpips import load_lpips

    return kind, load_lpips(src, "cpu").state_dict()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--kind", default="auto", choices=KINDS)
    parser.add_argument("--conf", default=None,
                        help="SRFlow conf yml (for --kind srflow)")
    args = parser.parse_args(argv)
    kind, payload = convert(args.src, args.kind, args.conf)
    save_checkpoint(args.dst, payload)
    print(f"converted {args.src} ({kind}) -> {args.dst}")


if __name__ == "__main__":
    main()
