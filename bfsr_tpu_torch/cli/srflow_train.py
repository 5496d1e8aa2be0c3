"""SRFlow-LP latent-module (prior) training CLI: the counterpart of
``srflow_train.py --prior``.

    python -m bfsr_tpu_torch.cli.srflow_train <conf.yml> --prior \\
        [--niter N] [--seed N] [--device cuda|cpu] \\
        [--precision high|highest|mixed|default]

It reads the reference's SRFlow conf schema, as ``srflow_train.py``
does: ``datasets.train`` (``LRHR_PKL`` pickles: ``dataroot_GT``,
``dataroot_LQ``, ``GT_size``, ``use_flip``, ``batch_size``,
``n_workers``), ``network_G``, ``model_path`` (a torch file of the
reference's SRFlow ``state_dict``) and ``prior_model`` /
``prior_model_path`` (a checkpoint of this trainer, or a torch file of
the reference prior's ``state_dict``), ``path.resume_state: auto``,
``train`` (``lr_G``, ``beta1``, ``beta2``, ``lr_scheme``,
``lr_steps_rel`` or ``lr_steps``, ``lr_gamma``, restarts, ``warmup_iter``,
``niter``, ``weight_eps``, ``weight_img``, ``manual_seed``) and
``logger`` (``print_freq``, ``save_checkpoint_freq``).

Without ``model_path`` the flow is random with the reference's zero
actnorms and zero coupling tails (smoke-test mode, loudly), and its
actnorms are primed from the first batch, as the JAX CLI primes them.
Every ``save_checkpoint_freq`` iterations it writes ``prior_<iter>.ckpt``
under ``./save/<name>-prior`` and keeps the two newest ``prior_`` files;
at the end ``prior_latest.ckpt`` (``{'prior_model': {'name', 'args',
'sd'}, 'optimizer': {'name', 'args', 'sd'}, 'iter'}``); with
``resume_state: auto`` it resumes from the newest ``prior_`` checkpoint,
optimizer and iteration included.

Not ported yet, and refused with a message naming ``ROADMAP.md`` queue 1:
the base model's NLL training (no ``--prior``) and the RRDB's SR training
(``model: sr``); the JAX CLI's ``--orbax`` saves.
"""

import argparse
import os
import random

import numpy as np
import torch

import bfsr_tpu_torch.data.pkl_dataset  # noqa: F401  (registers)
import bfsr_tpu_torch.models  # noqa: F401  (registers)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.data.loader import DataLoader
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step)
from bfsr_tpu_torch.train import checkpoints as ckpt
from bfsr_tpu_torch.train.optim import (cosine_restart, lr_scheduler,
                                        make_optimizer, multi_step_restart,
                                        with_warmup)
from bfsr_tpu_torch.utils.misc import log, set_save_path

LATER = {"srflow": "SRFlow base-model (NLL) training is not ported yet "
                   "(ROADMAP.md queue 1); pass --prior to train the "
                   "SRFlow-LP prior on a frozen flow",
         "sr": "RRDB SR training (model: sr) is not ported yet (ROADMAP.md "
               "queue 1)"}


def make_loader(opt, seed=0):
    """The ``lrhr-pkl`` loader of ``datasets.train`` (``_make_loader``)."""
    dtrain = opt["datasets"]["train"]
    dataset = registry.make({"name": "lrhr-pkl", "args": {
        "dataroot_GT": dtrain["dataroot_GT"],
        "dataroot_LQ": dtrain["dataroot_LQ"],
        "use_flip": dtrain.get("use_flip", False),
        "gt_size": dtrain.get("GT_size")}})
    return DataLoader(dataset, batch_size=dtrain["batch_size"], shuffle=True,
                      num_workers=dtrain.get("n_workers", 3), drop_last=True,
                      seed=seed)


def make_schedule(train_opt, niter, base_lr):
    """The conf's LR schedule with its warmup (``_make_schedule`` and
    ``_wrap_warmup``)."""
    restarts = train_opt.get("restarts") or ()
    weights = train_opt.get("restart_weights") or ()
    if train_opt.get("lr_scheme", "MultiStepLR") == \
            "CosineAnnealingLR_Restart":
        schedule = cosine_restart(base_lr, train_opt["T_period"],
                                  eta_min=train_opt.get("eta_min", 1e-7),
                                  restarts=restarts, restart_weights=weights)
    else:
        steps_rel = train_opt.get("lr_steps_rel")
        lr_steps = ([int(r * niter) for r in steps_rel] if steps_rel
                    else train_opt.get("lr_steps", []))
        schedule = multi_step_restart(base_lr, lr_steps,
                                      train_opt.get("lr_gamma", 0.5),
                                      restarts=restarts,
                                      restart_weights=weights)
    return with_warmup(schedule, base_lr, train_opt.get("warmup_iter", -1))


def build_srflow(opt):
    """The conf's ``network_G`` as an ``SRFlowNet`` (``srflow_test.py:
    build_srflow_from_conf``)."""
    g = opt["network_G"]
    flow = g["flow"]
    return registry.make({"name": "srflow", "args": {
        "in_nc": g.get("in_nc", 3), "out_nc": g.get("out_nc", 3),
        "nf": g.get("nf", 64), "nb": g.get("nb", 23), "gc": g.get("gc", 32),
        "scale": opt.get("scale", 4),
        "K": flow.get("K", 16), "L": flow.get("L", 3),
        "hidden_channels": flow.get("hidden_channels", 64),
        "additional_steps": flow.get("additionalFlowNoAffine", 2),
        "split_enable": bool((flow.get("split") or {}).get("enable")),
        "stack_blocks": tuple((flow.get("stackRRDB") or {}).get("blocks",
                                                                 ())),
        "stack_concat": bool((flow.get("stackRRDB") or {}).get("concat")),
        "fea_up0": bool(flow.get("fea_up0")),
        "quant": ((opt.get("datasets") or {}).get("train") or {}).get(
            "quant", 32)}})


def _state_dict(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_srflow(opt, device):
    """The frozen flow: ``model_path``'s weights, else random."""
    model = build_srflow(opt)
    path = opt.get("model_path")
    if path and os.path.exists(path):
        model.load_state_dict(_state_dict(path))
    else:
        log(f"WARNING: model_path {path!r} missing; random init (smoke-test "
            "mode)")
    return model.to(device).eval().freeze()


def load_prior(opt, device):
    """The prior to train: ``prior_model_path`` (a checkpoint of this
    trainer, or the reference's ``state_dict``), else random."""
    spec = dict(opt["prior_model"])
    if spec["name"] == "unet":
        spec = {"name": "srflow-unet", "args": spec.get("args") or {}}
    path = opt.get("prior_model_path")
    if path and os.path.exists(path):
        sv = torch.load(path, map_location="cpu", weights_only=True)
        if "prior_model" in sv:
            spec, sd = sv["prior_model"], sv["prior_model"]["sd"]
        else:
            sd = _state_dict(path)
        prior = registry.make(spec)
        prior.load_state_dict(sd)
    else:
        log(f"WARNING: prior_model_path {path!r} missing; random init")
        prior = registry.make(spec)
    return prior.to(device).train()


def _save(path, prior, optimizer, opt_spec, it):
    ckpt.save_checkpoint(path, {
        "prior_model": {**prior.spec(), "sd": prior.state_dict()},
        "optimizer": {**opt_spec, "sd": optimizer.state_dict()},
        "iter": it})


def train_prior(opt, niter=None, seed=0, device="cuda"):
    """The SRFlow-LP prior on a frozen flow (``srflow_train.py:
    train_prior``)."""
    device = torch.device(device)
    train_opt = opt["train"]
    niter = niter or train_opt["niter"]
    save_path = os.path.join("./save", opt.get("name", "srflow") + "-prior")
    _, writer = set_save_path(save_path)
    loader = make_loader(opt, seed)
    model = load_srflow(opt, device)
    prior = load_prior(opt, device)

    start_iter, sv = 0, None
    if (opt.get("path") or {}).get("resume_state") == "auto":
        newest = ckpt.find_auto_resume(save_path, prefix="prior_")
        if newest:
            sv = ckpt.load_checkpoint(newest)
            prior.load_state_dict(sv["prior_model"]["sd"])
            start_iter = int(sv.get("iter", 0))
            log(f"auto-resumed from {newest} at iter {start_iter}")

    base_lr = float(train_opt["lr_G"])
    opt_spec = {"name": "adam", "args": {
        "lr": base_lr, "betas": [train_opt.get("beta1", 0.9),
                                 train_opt.get("beta2", 0.99)]}}
    optimizer = make_optimizer(opt_spec, prior.parameters())
    if sv is not None:
        optimizer.load_state_dict(sv["optimizer"]["sd"])
    scheduler = lr_scheduler(optimizer,
                             make_schedule(train_opt, niter, base_lr),
                             base_lr, count=start_iter)
    step = make_srflow_prior_train_step(
        model, prior, optimizer,
        eps_weight=train_opt.get("weight_eps", 1.0) or 0.0,
        image_weight=train_opt.get("weight_img", 0.0) or 0.0,
        scheduler=scheduler)

    logger = opt.get("logger") or {}
    print_freq = logger.get("print_freq", 100)
    save_freq = int(logger.get("save_checkpoint_freq", 1000))
    it = start_iter
    while it < niter:
        for batch in loader:
            if it >= niter:
                break
            if it == start_iter == 0 and \
                    model.flowUpsamplerNet.actnorms_unprimed():
                log("priming actnorms from the first batch "
                    "(FlowActNorms.py:45-59)")
                model.prime_actnorms(
                    torch.as_tensor(batch["GT"], device=device),
                    torch.as_tensor(batch["LQ"], device=device))
            mets = step(batch)
            if it % print_freq == 0:
                log(f"iter {it}: " + ", ".join(f"{k}={v:.4f}"
                                               for k, v in mets.items()))
                writer.add_scalars("train", mets, it)
            if it and it % save_freq == 0:
                _save(os.path.join(save_path, f"prior_{it + 1}.ckpt"), prior,
                      optimizer, opt_spec, it + 1)
                ckpt.keep_newest(save_path, "prior_", 2)
            it += 1
    _save(os.path.join(save_path, "prior_latest.ckpt"), prior, optimizer,
          opt_spec, it)
    writer.close()
    log("training done")


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("conf")
    parser.add_argument("--niter", type=int, default=None)
    parser.add_argument("--prior", action="store_true",
                        help="train the SRFlow-LP latent module (prior) on "
                             "a frozen flow")
    parser.add_argument("--seed", type=int, default=None,
                        help="the seed of the shuffle, the crops and the "
                             "flips (default: train.manual_seed, else 0)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest", "mixed"],
                        help="high (the default), highest, mixed (the "
                             "prior in bf16) or default (every stage bf16)")
    args = parser.parse_args(argv)
    import yaml

    with open(args.conf) as f:
        opt = yaml.safe_load(f)
    if opt.get("model") == "sr":
        raise NotImplementedError(LATER["sr"])
    if not (args.prior or str(opt.get("model", "")).lower()
            in ("srflowprior", "srflow-prior")):
        raise NotImplementedError(LATER["srflow"])
    if args.precision:
        fnn.set_default_precision(args.precision)
    seed = args.seed
    if seed is None:
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    train_prior(opt, args.niter, seed, args.device)


if __name__ == "__main__":
    cli()
