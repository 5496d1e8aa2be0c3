"""LINF-LP latent-module training CLI: the counterpart of ``train.py``.

    python -m bfsr_tpu_torch.cli.train \\
        --config configs/train/train_edsr-baseline-linf-LP.yaml \\
        [--name NAME] [--tag TAG] [--patch PS] [--seed N] \\
        [--device cuda|cpu] [--precision high|highest|mixed|default] \\
        [--allow_random_vgg]

It reads the JAX trainer's YAML schema: ``train_dataset`` (dataset and
wrapper specs, ``batch_size``; ``-crop`` is appended to the wrapper's
name), ``model`` and its ``resume`` checkpoint, ``prior_model`` and
``resume_prior_model``, ``optimizer``, ``epoch_max``, ``multi_step_lr``
(milestones in epochs, stepped per iteration), ``loss_weight`` {vgg,
latent}, ``data_norm``, ``epoch_save``, ``vgg_weights``, and
``val_dataset`` (dataset and wrapper specs, ``batch_size``) with
``epoch_val``, ``eval_type`` and ``eval_bsize``: every ``epoch_val``
epochs it logs ``val: psnr=`` and writes the scalar ``psnr``, the mean
PSNR of ``pipelines.linf_eval.eval_psnr`` over the val loader.  The
config's val wrapper (``sr-implicit-downsampled-fast`` with
``inp_size``) draws a random subset of HR queries, not a grid:
``eval_psnr`` predicts each query at its own coordinate
(``LINFPredictor.predict``), the reference's semantics.  ``resume``
and ``vgg_weights`` are torch files: the reference's LINF checkpoint
(``{'model': {'name', 'args', 'sd'}}``) and torchvision's VGG19
``state_dict``.  Each epoch writes ``prior_model-epoch-last.ckpt`` (and
``prior_model-epoch-N.ckpt`` every ``epoch_save``) under ``./save/<name>``;
``resume_prior_model`` resumes from one, optimizer and epoch included.
The encoder is any the registry has (``configs/train/
train_rrdb-linf-LP.yaml``: RRDB on ``image-folder-DF2K``) and the latent
module any of ``unet``, ``swin_latent`` and ``edsr-baseline-latent``;
``swin_latent`` trains with stochastic depth, drawn from a
``torch.Generator`` seeded with ``--seed``.

``--patch PS`` (odd, > 1) trains the patch model's prior, as ``train.py``
rewrites the config: ``-patch`` on the train wrapper (with
``patch_size``) and on the model (``linf-patch``, ``patch_size``), and the
prior's ``in_chans`` 3 PS^2.  ``--precision`` sets the mode
(``ops/nn.py``): ``mixed`` trains the prior in bf16, ``default`` every
conv that reads the mode.

``loader: grain`` in a dataset spec reads it through
``data.sharded_loader.ShardedLoader``, the grain loader's twin: this
rank's slice of one global shuffle (the whole dataset without a process
group).  Not yet ported: validation of the patch model, skipped with a
warning (``--patch`` with a ``val_dataset`` trains without it): the val
wrapper's random query subset has no patch-centre grid to fold into
(``ROADMAP.md`` queue 3).
"""

import argparse
import os
import random

import numpy as np
import torch

import bfsr_tpu_torch.data.image_folder  # noqa: F401  (registers)
import bfsr_tpu_torch.data.wrappers  # noqa: F401  (registers)
import bfsr_tpu_torch.models  # noqa: F401  (registers)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.data.loader import DataLoader
from bfsr_tpu_torch.data.sharded_loader import ShardedLoader
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.pipelines.linf_eval import eval_psnr
from bfsr_tpu_torch.pipelines.linf_train import make_train_step
from bfsr_tpu_torch.train import checkpoints as ckpt
from bfsr_tpu_torch.train.optim import (lr_scheduler, make_optimizer,
                                        multi_step_lr)
from bfsr_tpu_torch.utils.misc import (Averager, Timer, compute_num_params,
                                       log, set_save_path, time_text)

LATER = {"patch validation": "validation of the patch model (--patch with a "
                             "val_dataset) is not ported: the val wrapper's "
                             "random query subset has no patch-centre grid "
                             "to fold into, in the JAX package either "
                             "(ROADMAP.md queue 3); this run trains "
                             "without validation"}


def make_data_loader(spec, seed=0, tag="train"):
    """The loader of a dataset spec: shuffled for ``tag`` 'train', in
    order for 'val'."""
    dataset = registry.make(spec["dataset"])
    dataset = registry.make({"name": spec["wrapper"]["name"],
                             "args": {**(spec["wrapper"].get("args") or {}),
                                      "dataset": dataset}})
    log(f"{tag} dataset: size={len(dataset)}")
    if spec.get("loader") == "grain":
        # the grain loader's twin: this rank's slice of a global shuffle
        # (every epoch reshuffled from seed + epoch alike on every rank)
        return ShardedLoader(dataset, batch_size=spec["batch_size"],
                             shuffle=tag == "train", seed=seed,
                             num_workers=4)
    return DataLoader(dataset, batch_size=spec["batch_size"],
                      shuffle=tag == "train", num_workers=4, seed=seed)


def load_linf(config, device):
    """The frozen LINF: the ``resume`` checkpoint, else random weights."""
    path = config.get("resume")
    if path and os.path.exists(path):
        spec = ckpt.load_checkpoint(path)["model"]
        model = registry.make(spec)
        model.load_state_dict(spec["sd"])
    else:
        model = registry.make(config["model"])
        log("WARNING: no LINF resume checkpoint found; using random init "
            "(smoke-test mode)")
    return model.to(device).eval().freeze()


def load_vgg(config, device):
    vgg = registry.make({"name": "VGGFeatureExtractor", "args": {}})
    path = config.get("vgg_weights")
    if path and os.path.exists(path):
        sd = ckpt.load_checkpoint(path)
        sd = {k: v for k, v in sd.items()
              if k.startswith("features.") and k in vgg.state_dict()}
        vgg.load_state_dict(sd)
    elif config.get("allow_random_vgg"):
        log("WARNING: no VGG19 weights given (config key 'vgg_weights'); "
            "the perceptual loss uses RANDOM features (allow_random_vgg)")
    else:
        raise SystemExit(
            "loss_weight.vgg > 0 but no VGG19 weights were given (config "
            "key 'vgg_weights': torchvision's vgg19 state_dict). Training a "
            "perceptual loss on random features produces noise — pass "
            "--allow_random_vgg to override.")
    return vgg.to(device).eval().requires_grad_(False)


def main(config, save_path, seed=0, device="cuda"):
    import yaml

    _, writer = set_save_path(save_path)
    with open(os.path.join(save_path, "config.yaml"), "w") as f:
        yaml.dump(config, f, sort_keys=False)
    device = torch.device(device)
    train_loader = make_data_loader(config["train_dataset"], seed)
    val_loader = None
    if config.get("val_dataset"):
        if config["model"]["name"].endswith("-patch"):
            log(f"WARNING: {LATER['patch validation']}")
        else:
            val_loader = make_data_loader(config["val_dataset"], seed, "val")
    data_norm = config.get("data_norm") or {
        "inp": {"sub": [0], "div": [1]}, "gt": {"sub": [0], "div": [1]}}

    linf = load_linf(config, device)
    log(f"LINF model: #params={compute_num_params(linf, text=True)}")

    epoch_start, resumed = 1, None
    path = config.get("resume_prior_model")
    if path and os.path.exists(path):
        resumed = ckpt.load_checkpoint(path)
        spec = resumed["prior_model"]
        prior = registry.make(spec)
        prior.load_state_dict(spec["sd"])
        epoch_start = int(resumed.get("epoch", 0)) + 1
        log(f"resume training from epoch {epoch_start}")
    else:
        prior = registry.make(config["prior_model"])
    prior = prior.to(device).train()
    log(f"Latent module: #params={compute_num_params(prior, text=True)}")

    optimizer = make_optimizer(config["optimizer"], prior.parameters())
    if resumed is not None:
        optimizer.load_state_dict(resumed["optimizer"]["sd"])
    iters_per_epoch = len(train_loader)
    it = (epoch_start - 1) * iters_per_epoch
    base_lr = config["optimizer"]["args"]["lr"]
    mslr = config.get("multi_step_lr")
    # gamma 0.1 by default: the reference hands the dict to torch's
    # MultiStepLR, whose default it is
    scheduler = (lr_scheduler(optimizer, multi_step_lr(
        base_lr, [m * iters_per_epoch for m in mslr["milestones"]],
        mslr.get("gamma", 0.1)), base_lr, count=it) if mslr else None)

    vgg_weight = config["loss_weight"]["vgg"]
    latent_weight = config["loss_weight"]["latent"]
    vgg = load_vgg(config, device) if vgg_weight > 0 else None
    # stochastic depth's draws (swin_latent's; the other latent modules
    # draw none), seeded as train.py seeds its dp_key
    generator = torch.Generator(device=device).manual_seed(seed)
    step = make_train_step(linf, prior, vgg, optimizer,
                           vgg_weight=vgg_weight, latent_weight=latent_weight,
                           data_norm=data_norm, scheduler=scheduler,
                           generator=generator)

    epoch_max, epoch_save = config["epoch_max"], config.get("epoch_save")
    epoch_val = config.get("epoch_val")
    timer = Timer()
    for epoch in range(epoch_start, epoch_max + 1):
        t_epoch = timer.t()
        vgg_avg, lat_avg = Averager(), Averager()
        for batch in train_loader:
            mets = step(batch)
            vgg_avg.add(mets["vgg_l"])
            lat_avg.add(mets["latent_l"])
            writer.add_scalars("loss", {"vgg_loss": mets["vgg_l"],
                                        "latent_loss": mets["latent_l"]}, it)
            it += 1
        sv = ckpt.train_state(prior, optimizer, config["optimizer"], epoch)
        ckpt.save_checkpoint(
            os.path.join(save_path, "prior_model-epoch-last.ckpt"), sv)
        if epoch_save and epoch % epoch_save == 0:
            ckpt.save_checkpoint(
                os.path.join(save_path, f"prior_model-epoch-{epoch}.ckpt"),
                sv)
        val = ""
        if epoch_val and epoch % epoch_val == 0 and val_loader is not None:
            prior.eval()
            psnr = eval_psnr(val_loader, linf, prior.freeze(),
                             data_norm=data_norm,
                             eval_type=config.get("eval_type"),
                             eval_bsize=config.get("eval_bsize"))
            prior.train()
            val = f"val: psnr={psnr:.4f}, "
            writer.add_scalar("psnr", psnr, epoch)
        t = timer.t()
        prog = (epoch - epoch_start + 1) / (epoch_max - epoch_start + 1)
        log(f"epoch {epoch}/{epoch_max}, train: vgg_l={vgg_avg.item():.4f}, "
            f"latent_l: {lat_avg.item():.4f}, {val}{time_text(t - t_epoch)} "
            f"{time_text(t)}/{time_text(t / prog)}")
        writer.flush()
    writer.close()


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--name", default=None)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--patch", type=int, default=None,
                        help="patch size (odd, > 1): train the patch "
                             "model's prior")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--allow_random_vgg", action="store_true",
                        help="train the perceptual loss on random VGG "
                             "features when no weights are given")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest", "mixed"],
                        help="high (the default), highest, mixed (the "
                             "prior in bf16) or default (bf16 convs)")
    args = parser.parse_args(argv)
    if args.patch is not None and (args.patch <= 1 or args.patch % 2 == 0):
        parser.error("--patch must be an odd integer > 1 (patch models "
                     "query patch-centre coordinates)")
    if args.precision:
        fnn.set_default_precision(args.precision)

    import yaml

    with open(args.config) as f:
        config = yaml.safe_load(f)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    name = args.name or "_" + os.path.basename(args.config)[:-len(".yaml")]
    if args.tag is not None:
        name += "_" + args.tag
    config["train_dataset"]["wrapper"]["name"] += "-crop"
    if args.patch:
        wrapper = config["train_dataset"]["wrapper"]
        wrapper["name"] += "-patch"
        wrapper.setdefault("args", {})["patch_size"] = args.patch
        config["model"]["name"] += "-patch"
        config["model"]["args"]["patch_size"] = args.patch
        config["prior_model"]["args"]["in_chans"] = 3 * args.patch ** 2
    if args.allow_random_vgg:
        config["allow_random_vgg"] = True
    main(config, os.path.join("./save", name), seed=args.seed,
         device=args.device)


if __name__ == "__main__":
    cli()
