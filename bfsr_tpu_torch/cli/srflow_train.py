"""SRFlow training CLI: the counterpart of ``srflow_train.py``.

    python -m bfsr_tpu_torch.cli.srflow_train <conf.yml> [--prior] \\
        [--niter N] [--seed N] [--device cuda|cpu] \\
        [--precision high|highest|mixed|default]

It reads the reference's SRFlow conf schema, as ``srflow_train.py``
does: ``datasets.train`` (``LRHR_PKL`` pickles: ``dataroot_GT``,
``dataroot_LQ``, ``GT_size``, ``use_flip``, ``batch_size``,
``n_workers``, ``quant``), ``network_G``, ``path`` (``resume_state:
auto``, ``pretrain_model_G``), ``train`` (``lr_G``, ``beta1``,
``beta2``, ``lr_scheme``, ``lr_steps_rel`` or ``lr_steps``,
``lr_gamma``, restarts, ``warmup_iter``, ``niter``, ``manual_seed``) and
``logger`` (``print_freq``, ``save_checkpoint_freq``).  It runs on the
card unless ``--device`` names another; ``--precision`` sets the mode of
every trainer.  Three trainers:

* the SRFlow base model (the default): the NLL in bits/dim
  (``train.weight_fl``) plus an optional heat-0 L1 (``weight_l1``), the
  RRDB frozen (its dense-block convs on K3) for the first
  ``network_G.train_RRDB_delay * niter`` iterations and trained after
  (``pipelines/srflow_train.py``); ``path.pretrain_model_G``, when the
  file exists, is loaded into the RRDB (a torch file of the reference's
  RRDB keys, a checkpoint of the ``model: sr`` trainer, or a JAX
  ``.ckpt`` of its params); a fresh run primes the flow's actnorms from
  its first batch.  Saves ``./save/<name>/G_<iter>.ckpt`` every
  ``save_checkpoint_freq`` iterations (the two newest ``G_`` files kept)
  and ``G_latest.ckpt`` at the end: ``{'model': {'name', 'args', 'sd'},
  'optimizer': {'name', 'args', 'sd'}, 'iter'}``, which ``model_path``
  of ``cli/srflow_test.py`` and ``--prior`` read;
* ``model: sr``: the RRDB x4 generator with ``train.pixel_criterion``
  (``l1`` | ``l2`` | ``cb``) and ``pixel_weight``
  (``pipelines/sr_train.py``), saved the same way;
* ``--prior`` (or ``model: SRFlowPrior``): the SRFlow-LP latent module
  on a frozen flow (``pipelines/srflow_prior_train.py``): ``model_path``
  (the flow), ``prior_model`` / ``prior_model_path``, ``train.weight_eps``
  / ``weight_img``; without ``model_path`` the flow is random with the
  reference's zero actnorms and zero coupling tails (smoke-test mode,
  loudly), its actnorms primed from the first batch.  Saves
  ``prior_<iter>.ckpt`` under ``./save/<name>-prior`` (two kept) and
  ``prior_latest.ckpt`` (``{'prior_model': {'name', 'args', 'sd'},
  'optimizer': ..., 'iter'}``).

With ``resume_state: auto`` each resumes from its newest checkpoint,
optimizer and iteration included.  Each logs ``iter N: <loss>=...``
lines every ``print_freq`` iterations.  The JAX CLI's ``--orbax`` saves
have no counterpart.
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

def make_loader(opt, seed=0):
    """The ``lrhr-pkl`` loader of ``datasets.train`` (``_make_loader``)."""
    dtrain = opt["datasets"]["train"]
    dataset = registry.make({"name": "lrhr-pkl", "args": {
        "dataroot_GT": dtrain["dataroot_GT"],
        "dataroot_LQ": dtrain["dataroot_LQ"],
        "use_flip": dtrain.get("use_flip", False),
        "gt_size": dtrain.get("GT_size"), "scale": opt.get("scale", 4)}})
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


def _state_dict(sd):
    """A reference ``state_dict`` (``state_dict`` key and ``module.``
    prefixes dropped), or the model of a checkpoint of this CLI."""
    if "model" in sd and "sd" in sd["model"]:
        return sd["model"]["sd"]
    sd = sd.get("state_dict", sd)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_srflow(opt, device):
    """The frozen flow: ``model_path``'s weights (a torch file of the
    reference's ``state_dict``, or a JAX ``.ckpt`` with ``params``), else
    random.  Shared by the trainer and ``cli/srflow_test.py``."""
    from bfsr_tpu_torch.convert.from_jax import srflow_state_dict
    from bfsr_tpu_torch.convert.load import read_checkpoint

    model = build_srflow(opt)
    path = opt.get("model_path")
    if path and os.path.exists(path):
        kind, payload = read_checkpoint(path)
        model.load_state_dict(_state_dict(payload) if kind == "torch" else
                              srflow_state_dict(payload["params"],
                                                model.plan))
    else:
        log(f"WARNING: model_path {path!r} missing; random init (smoke-test "
            "mode)")
    return model.to(device).eval().freeze()


def load_prior(opt, device, train=True):
    """The prior: ``prior_model_path`` (a checkpoint of this trainer, the
    reference's ``state_dict`` or a JAX ``.ckpt``), else random; in train
    mode for the trainer, else eval mode and frozen.  Shared by the
    trainer and ``cli/srflow_test.py``."""
    from bfsr_tpu_torch.convert.load import load_prior_model, read_checkpoint

    spec = dict(opt["prior_model"])
    if spec["name"] == "unet":
        spec = {"name": "srflow-unet", "args": spec.get("args") or {}}
    path = opt.get("prior_model_path")
    if path and os.path.exists(path):
        kind, payload = read_checkpoint(path)
        if kind == "torch" and "prior_model" not in payload:
            prior = registry.make(spec)
            prior.load_state_dict(_state_dict(payload))
        else:
            prior = load_prior_model(path, device)
    else:
        log(f"WARNING: prior_model_path {path!r} missing; random init")
        prior = registry.make(spec)
    prior = prior.to(device)
    return prior.train() if train else prior.eval().freeze()


def _prime(model, batch, device):
    """Prime a random flow's actnorms from the first batch of a fresh
    run (``_maybe_prime_actnorms``)."""
    if model.flowUpsamplerNet.actnorms_unprimed():
        log("priming actnorms from the first batch (FlowActNorms.py:45-59)")
        model.prime_actnorms(torch.as_tensor(batch["GT"], device=device),
                             torch.as_tensor(batch["LQ"], device=device))


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
    start_iter, sv = _resume(save_path, "prior_", "prior_model", prior, opt)
    optimizer, opt_spec, scheduler = _adam(train_opt, prior.parameters(), sv,
                                           niter, start_iter)
    step = make_srflow_prior_train_step(
        model, prior, optimizer,
        eps_weight=train_opt.get("weight_eps", 1.0) or 0.0,
        image_weight=train_opt.get("weight_img", 0.0) or 0.0,
        scheduler=scheduler)

    def run(batch, it):
        if it == start_iter == 0:
            _prime(model, batch, device)
        return step(batch)

    _loop(opt, save_path, "prior_", loader, niter, start_iter, run,
          lambda path, it: _save(path, "prior_model", prior, optimizer,
                                 opt_spec, it), writer)


def load_rrdb_weights(path):
    """The reference-keyed ``state_dict`` of an RRDB in ``path``: a torch
    file of the reference's keys (or a ``model: sr`` checkpoint of this
    CLI), or a JAX ``.ckpt`` holding its ``params``."""
    from bfsr_tpu_torch.convert.from_jax import rrdb_state_dict
    from bfsr_tpu_torch.convert.load import read_checkpoint

    kind, payload = read_checkpoint(path)
    if kind == "torch":
        return _state_dict(payload)
    return rrdb_state_dict(payload["params"])


def _save(path, key, module, optimizer, opt_spec, it):
    ckpt.save_checkpoint(path, {
        key: {**module.spec(), "sd": module.state_dict()},
        "optimizer": {**opt_spec, "sd": optimizer.state_dict()},
        "iter": it})


def _resume(save_path, prefix, key, module, opt):
    """(start iteration, the checkpoint's payload or None): under
    ``resume_state: auto`` the newest ``prefix`` checkpoint's ``key``
    weights loaded into ``module``."""
    if (opt.get("path") or {}).get("resume_state") != "auto":
        return 0, None
    newest = ckpt.find_auto_resume(save_path, prefix=prefix)
    if not newest:
        return 0, None
    sv = ckpt.load_checkpoint(newest)
    module.load_state_dict(sv[key]["sd"])
    log(f"auto-resumed from {newest} at iter {sv.get('iter', 0)}")
    return int(sv.get("iter", 0)), sv


def _adam(train_opt, params, sv, niter, start_iter):
    """(Adam over ``params`` at ``lr_G`` / ``beta1`` / ``beta2``, its spec,
    the conf's schedule as a per-iteration scheduler), the optimizer's
    state from ``sv`` if resuming."""
    base_lr = float(train_opt["lr_G"])
    opt_spec = {"name": "adam", "args": {
        "lr": base_lr, "betas": [train_opt.get("beta1", 0.9),
                                 train_opt.get("beta2", 0.99)]}}
    optimizer = make_optimizer(opt_spec, params)
    if sv is not None:
        optimizer.load_state_dict(sv["optimizer"]["sd"])
    scheduler = lr_scheduler(optimizer,
                             make_schedule(train_opt, niter, base_lr),
                             base_lr, count=start_iter)
    return optimizer, opt_spec, scheduler


def _loop(opt, save_path, prefix, loader, niter, start_iter, run, save,
          writer):
    """The iteration loop: ``run(batch, it) -> metrics``, logged every
    ``print_freq``; ``save(path, it)`` every ``save_checkpoint_freq`` as
    ``<prefix><it + 1>.ckpt`` (the two newest kept) and at the end as
    ``<prefix>latest.ckpt``."""
    logger = opt.get("logger") or {}
    print_freq = logger.get("print_freq", 100)
    save_freq = int(logger.get("save_checkpoint_freq", 1000))
    it = start_iter
    while it < niter:
        for batch in loader:
            if it >= niter:
                break
            mets = run(batch, it)
            if it % print_freq == 0:
                log(f"iter {it}: " + ", ".join(f"{k}={v:.4f}"
                                               for k, v in mets.items()))
                writer.add_scalars("train", mets, it)
            if it and it % save_freq == 0:
                save(os.path.join(save_path, f"{prefix}{it + 1}.ckpt"),
                     it + 1)
                ckpt.keep_newest(save_path, prefix, 2)
            it += 1
    save(os.path.join(save_path, f"{prefix}latest.ckpt"), it)
    writer.close()
    log("training done")


def train_srflow(opt, niter=None, seed=0, device="cuda"):
    """The SRFlow base model's NLL training (``srflow_train.py:main``)."""
    from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step

    device = torch.device(device)
    opt = {**opt, "name": opt.get("name", "srflow")}
    train_opt = opt["train"]
    niter = niter or train_opt["niter"]
    save_path = os.path.join("./save", opt["name"])
    _, writer = set_save_path(save_path)
    loader = make_loader(opt, seed)
    model = build_srflow(opt)
    start_iter, sv = _resume(save_path, "G_", "model", model, opt)
    pre = (opt.get("path") or {}).get("pretrain_model_G")
    if start_iter == 0 and pre and os.path.exists(pre):
        model.RRDB.load_state_dict(load_rrdb_weights(pre))
        log(f"loaded pretrained RRDB from {pre}")
    model = model.to(device).freeze()
    optimizer, opt_spec, scheduler = _adam(train_opt, model.parameters(), sv,
                                           niter, start_iter)
    delay = opt["network_G"].get("train_RRDB_delay")
    unfreeze = int(delay * niter) if delay is not None else None
    gen = torch.Generator(device=device).manual_seed(
        int(train_opt.get("manual_seed") or 0))
    kw = dict(weight_fl=train_opt.get("weight_fl", 1.0) or 1.0,
              weight_l1=train_opt.get("weight_l1", 0.0) or 0.0,
              scheduler=scheduler, generator=gen)
    # the frozen phase on K3; the live step after the unfreeze (without a
    # delay the RRDB never trains, and the frozen step is the same update)
    frozen = make_srflow_train_step(model, optimizer, freeze_rrdb=True, **kw)
    live = make_srflow_train_step(model, optimizer,
                                  rrdb_unfreeze_step=unfreeze, **kw)

    def run(batch, it):
        if it == start_iter == 0:
            _prime(model, batch, device)
        step = frozen if unfreeze is None or it < unfreeze else live
        return step(batch, it)

    _loop(opt, save_path, "G_", loader, niter, start_iter, run,
          lambda path, it: _save(path, "model", model, optimizer, opt_spec,
                                 it), writer)


def train_sr(opt, niter=None, seed=0, device="cuda"):
    """The RRDB x4 generator's plain-SR training (``srflow_train.py:
    train_sr``, the reference's ``SR_model.py``)."""
    from bfsr_tpu_torch.pipelines.sr_train import make_sr_train_step

    device = torch.device(device)
    opt = {**opt, "name": opt.get("name", "sr")}
    train_opt = opt["train"]
    niter = niter or train_opt["niter"]
    net = opt["network_G"]
    which = net.get("which_model_G", "RRDBNet")
    if which != "RRDBNet":
        raise NotImplementedError(f"Generator model [{which}] not recognized")
    save_path = os.path.join("./save", opt["name"])
    _, writer = set_save_path(save_path)
    loader = make_loader(opt, seed)
    model = registry.make({"name": "rrdb", "args": {
        "in_nc": net.get("in_nc", 3), "out_nc": net.get("out_nc", 3),
        "nf": net.get("nf", 64), "nb": net.get("nb", 23),
        "gc": net.get("gc", 32), "no_upsampling": False}})
    start_iter, sv = _resume(save_path, "G_", "model", model, opt)
    model = model.to(device).train()
    optimizer, opt_spec, scheduler = _adam(train_opt, model.parameters(), sv,
                                           niter, start_iter)
    step = make_sr_train_step(
        model, optimizer,
        pixel_criterion=train_opt.get("pixel_criterion", "cb"),
        pixel_weight=train_opt.get("pixel_weight", 1.0), scheduler=scheduler)
    _loop(opt, save_path, "G_", loader, niter, start_iter,
          lambda batch, it: step(batch),
          lambda path, it: _save(path, "model", model, optimizer, opt_spec,
                                 it), writer)


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("conf")
    parser.add_argument("--niter", type=int, default=None)
    parser.add_argument("--prior", action="store_true",
                        help="train the SRFlow-LP latent module (prior) on "
                             "a frozen flow instead of the base NLL path")
    parser.add_argument("--seed", type=int, default=None,
                        help="the seed of the shuffle, the crops and the "
                             "flips (default: train.manual_seed, else 0)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest", "mixed"],
                        help="high (the default), highest, mixed (the "
                             "prior trainer's prior in bf16) or default "
                             "(every stage bf16)")
    args = parser.parse_args(argv)
    import yaml

    with open(args.conf) as f:
        opt = yaml.safe_load(f)
    if opt.get("model") == "sr":
        trainer = train_sr
    elif args.prior or str(opt.get("model", "")).lower() in (
            "srflowprior", "srflow-prior"):
        trainer = train_prior
    else:
        trainer = train_srflow
    if args.precision:
        fnn.set_default_precision(args.precision)
    seed = args.seed
    if seed is None:
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    trainer(opt, args.niter, seed, args.device)


if __name__ == "__main__":
    cli()
