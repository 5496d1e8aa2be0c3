"""LINF-LP evaluation CLI: the counterpart of ``test.py``.

    python -m bfsr_tpu_torch.cli.test \\
        --config configs/test/test-fast-div2k-4.yaml \\
        --model edsr-baseline-linf.pth [--prior_model prior.pth] \\
        [--window W] [--scale_max S] [--sample N] [--detail] \\
        [--randomness] [--temperature T] [--patch] [--name NAME] \\
        [--name_sub SUB] [--limit N] [--tile_queries N] \\
        [--pad_multiple M] [--warmup] [--lpips_weights PATH] [--no_lpips] \\
        [--precision high|highest|mixed|default] [--device cuda|cpu]

``--model`` and ``--prior_model`` take a reference ``.pth``, a port
checkpoint or a JAX ``.ckpt`` (``convert/load.py``).  The config's
``test_dataset`` (dataset, wrapper, ``batch_size``), ``eval_type``,
``eval_bsize`` and ``data_norm`` drive ``pipelines.linf_eval.eval_psnr``.
``--patch`` evaluates a patch model: ``-patch`` is appended to the
wrapper's name (and ``-test`` after it for a downsampling wrapper), with
the model's ``patch_size``.  ``--detail`` prints psnr, ssim, lpips and LR
recon (and diversity with ``--randomness``); it needs LPIPS weights
(``--lpips_weights``) or ``--no_lpips``, and says so before any model is
loaded.  ``--sample N`` saves the first N predictions under
``./sample[/NAME[/SUB]]``.  ``--warmup`` predicts once per LR-shape
bucket first (the shapes read from the image headers where the config
allows, else from the loader).  ``--tile_queries`` and ``eval_bsize`` are
accepted and change nothing: the port computes each image whole.
"""

import argparse
import math
import os

import torch

import bfsr_tpu_torch.data.image_folder  # noqa: F401  (registers)
import bfsr_tpu_torch.data.wrappers  # noqa: F401  (registers)
import bfsr_tpu_torch.models  # noqa: F401  (registers)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.load import load_linf_model, load_prior_model
from bfsr_tpu_torch.data.loader import DataLoader
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr, warmup_predictor


def warmup_lr_shapes(wrapper, spec, limit):
    """The LR shapes of ``--warmup`` from the image files' headers (PIL
    reads the size without decoding), or None where they cannot be told
    without decoding (in-memory or pickled caches, random scales, other
    wrappers): the caller then iterates the loader."""
    from PIL import Image

    wname = spec["wrapper"]["name"]
    wargs = spec["wrapper"].get("args") or {}
    if wargs.get("inp_size"):
        n = int(wargs["inp_size"])
        return [(n, n)]
    src = getattr(wrapper, "dataset", None)
    if "paired" in wname:
        files = getattr(getattr(src, "dataset_1", None), "files", None)
        scale = None
    elif "downsampled" in wname:
        s_min = wargs.get("scale_min", 1)
        if wargs.get("scale_max", s_min) != s_min:
            return None
        scale = float(s_min)
        files = getattr(src, "files", None)
    else:
        return None
    if not files:
        return None
    if limit is not None:
        files = files[:limit]
    shapes = []
    for f in files:
        if not isinstance(f, str) or f.endswith(".pkl"):
            return None
        w, h = Image.open(f).size
        if scale:
            h = math.floor(h / scale + 1e-9)
            w = math.floor(w / scale + 1e-9)
        shapes.append((h, w))
    return shapes


def save_path_of(name, name_sub):
    if name is None:
        return "./sample"
    if name_sub is not None:
        return os.path.join("./sample", name, name_sub)
    return os.path.join("./sample", name)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--model", required=True)
    parser.add_argument("--prior_model", default=None)
    parser.add_argument("--window", default="0")
    parser.add_argument("--scale_max", default="30")
    parser.add_argument("--sample", type=int, default=0)
    parser.add_argument("--detail", action="store_true")
    parser.add_argument("--randomness", action="store_true")
    parser.add_argument("--temperature", type=float, default=0)
    parser.add_argument("--patch", action="store_true")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--name_sub", type=str, default=None)
    parser.add_argument("--limit", type=int, default=None,
                        help="evaluate only the first N images")
    parser.add_argument("--tile_queries", type=int, default=65536,
                        help="accepted; the port computes images whole")
    parser.add_argument("--pad_multiple", type=int, default=0,
                        help="reflect-pad each LR past this multiple")
    parser.add_argument("--warmup", action="store_true",
                        help="predict once per LR-shape bucket before the "
                             "sweep (builds the kernels, primes cuDNN)")
    parser.add_argument("--lpips_weights", default=None,
                        help="LPIPS-alex weights (the lpips package's "
                             "state_dict, or a JAX .ckpt); required for "
                             "--detail unless --no_lpips")
    parser.add_argument("--no_lpips", action="store_true",
                        help="skip the LPIPS metric in --detail mode")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest", "mixed"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.precision:
        fnn.set_default_precision(args.precision)
    import yaml

    with open(args.config) as f:
        config = yaml.safe_load(f)
    device = torch.device(args.device)

    # LPIPS is the paper's headline metric: refuse before the model load
    # rather than report nan
    lpips_model = None
    if args.lpips_weights:
        from bfsr_tpu_torch.models.lpips import load_lpips

        lpips_model = load_lpips(args.lpips_weights, device)
    elif args.detail and not args.no_lpips:
        raise SystemExit(
            "--detail computes LPIPS (the paper's headline metric) but no "
            "weights were given: pass --lpips_weights (the lpips package's "
            "alexnet state_dict, or a converted .ckpt), or --no_lpips to "
            "skip it.")

    model = load_linf_model(args.model, freeze=True, device=device)
    prior_model = (load_prior_model(args.prior_model, device)
                   if args.prior_model else None)

    spec = config["test_dataset"]
    if args.patch:
        wrapper = spec["wrapper"]
        wrapper["name"] += "-patch"
        if "downsampled" in wrapper["name"]:
            wrapper["name"] += "-test"
        wrapper.setdefault("args", {})["patch_size"] = model.patch_size
    dataset = registry.make(spec["dataset"])
    dataset = registry.make({"name": spec["wrapper"]["name"],
                             "args": {**(spec["wrapper"].get("args") or {}),
                                      "dataset": dataset}})
    loader = DataLoader(dataset, batch_size=spec["batch_size"], num_workers=8)

    eval_type = config.get("eval_type")
    if args.warmup:
        shapes = warmup_lr_shapes(dataset, spec, args.limit)
        if shapes is None:
            shapes = []
            for i, batch in enumerate(loader):
                if args.limit is not None and i >= args.limit:
                    break
                shapes.append(tuple(batch["inp"].shape[1:3]))
        warmup_predictor(model, prior_model, shapes,
                         scale=(int(args.scale_max) if eval_type is None
                                else int(eval_type.split("-")[-1])),
                         pad_multiple=int(args.window) or args.pad_multiple)

    res = eval_psnr(
        loader, model, prior_model=prior_model,
        data_norm=config.get("data_norm"), eval_type=eval_type,
        eval_bsize=config.get("eval_bsize"), window_size=int(args.window),
        scale_max=int(args.scale_max), verbose=True, detail=args.detail,
        randomness=args.randomness, temperature=args.temperature,
        patch=args.patch, tile_queries=args.tile_queries,
        lpips_model=lpips_model, limit=args.limit, sample=args.sample,
        save_path=save_path_of(args.name, args.name_sub),
        pad_multiple=args.pad_multiple)
    if args.detail:
        for key, val in res.items():
            print(f"{key}: {val:.3f}")
    else:
        print(f"psnr: {res:.3f}")
    return res


if __name__ == "__main__":
    main()
