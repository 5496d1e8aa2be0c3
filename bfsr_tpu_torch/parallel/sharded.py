"""The sharded steps and predicts as one rank runs them, and the same work
on one process: what ``entry.dryrun_multichip``, the tests and
``chip_smoke.py`` drive in each rank (``mesh.spawn`` starts the ranks and
imports this module there; it imports neither jax nor the JAX package).

* ``run_step(kind, recipe, batch, mesh_axes, device, opts)``: one train
  step of ``kind`` ('linf': the LINF-LP prior's dp x sp step; 'srflow_nll':
  the SRFlow base model's dp NLL step; 'srflow_prior': the SRFlow-LP
  prior's dp step) on the models of ``recipe``: with ``mesh_axes`` in a
  rank (its mesh made, the models replicated from rank 0, the global
  ``batch`` sharded to the rank's part), without them alone on the whole
  batch.  It returns the step's metrics, the gradients, the launches of
  each kernel, the step's milliseconds and, with ``opts['adam']``, the
  parameters after one step of Adam.
* ``run_predict(kind, recipe, inputs, mesh_axes, device, opts)``:
  'linf_sp' (the query-sharded LINF-LP predict: this rank's rows of the
  HR grid), 'linf_dp' (B / dp images a rank, and the dp PSNR),
  'srflow_dp' (one LR a rank through ``SRFlowLPPredictor``) and
  'srflow_sp' (one LR whose width is split over sp,
  ``SRFlowSpatialPredictor``: this rank's SR strip, the halo exchanges'
  count and bytes).
* ``run_cases(cases, device)``: a list of either, in turn, in one rank:
  one spawn runs several.
* ``compare_steps`` / ``check_against_single``: the ranks' results of a
  step held against the same step on one process; ``compare_strips``:
  the ranks' SR strips of a 'srflow_sp' predict against the single
  predict's columns.

Every entry point takes the device it runs on: nothing here picks one.

A recipe is ``{'seed': s, 'tiny': t}`` (the models ``entry``'s builders
make from a seed, identical on every rank), optionally with ``'prime':
True`` (an SRFlow flow's actnorms primed from the global batch), or
``{name: (spec, state_dict of numpy arrays)}`` (the caller's weights).
"""

import time

import numpy as np
import torch

from bfsr_tpu_torch import registry
from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.parallel.mesh import (batch_specs_linf,
                                          batch_specs_srflow, make_mesh,
                                          replicate, shard_batch)

STEPS = ("linf", "srflow_nll", "srflow_prior")
PREDICTS = ("linf_sp", "linf_dp", "srflow_dp", "srflow_sp")


def state_of(module):
    """(spec, state_dict as numpy arrays) of a registry model: a recipe
    entry."""
    return module.spec(), {k: v.detach().cpu().numpy()
                           for k, v in module.state_dict().items()}


def _load(entry, device):
    spec, sd = entry
    m = registry.make(spec)
    missing, _ = m.load_state_dict({k: torch.as_tensor(v)
                                    for k, v in sd.items()}, strict=False)
    if missing:
        raise KeyError(f"{spec['name']}: the recipe's state lacks {missing}")
    return m.to(device)


def build(kind, recipe, device, batch=None):
    """The models of ``kind`` on ``device``: 'linf' / 'linf_sp' / 'linf_dp'
    -> (frozen LINF, prior, VGG or None); 'srflow_nll' -> (SRFlowNet,);
    'srflow_prior' / 'srflow_dp' / 'srflow_sp' -> (frozen SRFlowNet,
    prior)."""
    from bfsr_tpu_torch import entry

    seed, tiny = recipe.get("seed"), recipe.get("tiny", False)
    if kind.startswith("linf"):
        if "seed" in recipe and kind != "linf":
            return (*entry.build_flagship(device, seed, tiny), None)
        if "seed" in recipe:
            linf, prior, vgg = entry.build_flagship_trainer(device, seed, tiny)
        else:
            linf = _load(recipe["linf"], device).eval().freeze()
            prior = _load(recipe["prior"], device).train()
            vgg = (_load(recipe["vgg"], device).eval().requires_grad_(False)
                   if recipe.get("vgg") else None)
        if kind != "linf":
            prior.eval().freeze()
        return linf, prior, vgg
    if kind == "srflow_nll":
        if "seed" in recipe:
            model = registry.make(entry.srflow_specs(tiny)[0])
            model.reset_parameters(entry.seeded(seed))
            model = model.to(device).freeze()
        else:
            model = _load(recipe["srflow"], device).freeze()
        if recipe.get("prime"):
            model.prime_actnorms(*(torch.as_tensor(batch[k], device=device)
                                   for k in ("GT", "LQ")))
        return (model,)
    predict = kind in ("srflow_dp", "srflow_sp")
    if "seed" in recipe and predict:
        return entry.build_srflow_lp(device, seed, tiny)
    if "seed" in recipe:
        model, prior = entry.build_srflow_prior_trainer(device, seed, tiny)
    else:
        model = _load(recipe["srflow"], device).eval().freeze()
        prior = _load(recipe["prior"], device).train()
    if predict:
        prior.eval().freeze()
    return model, prior


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launched(device):
    _sync(device)
    return {k: v for k, v in cuda.LAUNCHES.items() if v}


def _np(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def make_step(kind, models, opts, mesh, device):
    """(the step of ``kind`` over ``models``, the module it trains)."""
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.pipelines.srflow_prior_train import (
        make_srflow_prior_train_step)
    from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    kernels = opts.get("kernels", True)
    trained = models[1] if kind in ("linf", "srflow_prior") else models[0]
    opt = make_optimizer({"name": "adam",
                          "args": {"lr": opts.get("lr", 1e-3)}},
                         trained.parameters())
    if kind == "linf":
        linf, prior, vgg = models
        step = make_train_step(
            linf, prior, vgg, opt, vgg_weight=opts.get("vgg_weight", 1.0),
            latent_weight=opts.get("latent_weight", 0.0),
            data_norm=opts.get("data_norm"), kernels=kernels, mesh=mesh)
    elif kind == "srflow_prior":
        step = make_srflow_prior_train_step(
            *models, opt, eps_weight=opts.get("eps_weight", 1.0),
            image_weight=opts.get("image_weight", 0.0), kernels=kernels,
            mesh=mesh)
    else:
        gen = torch.Generator(device=device).manual_seed(
            opts.get("noise_seed", 0))
        step = make_srflow_train_step(
            models[0], opt, 1.0, 0.0,
            rrdb_unfreeze_step=opts.get("rrdb_unfreeze_step"),
            freeze_rrdb=opts.get("freeze_rrdb", True), kernels=kernels,
            generator=gen, mesh=mesh)
    return step, trained


def _tensors(batch, device):
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device) for k, v in batch.items()}


def run_step(kind, recipe, batch, mesh_axes, device, opts=None, local=False,
             models=None):
    """One train step of ``kind`` (see the module docstring).  ``batch``:
    the global batch (numpy), or with ``local`` this rank's shard of it (a
    loader's); ``models``: ``build``'s, if the caller has them (a step
    without ``adam`` leaves them as they were); ``opts``: the loss
    weights, ``lr``, ``kernels``, ``noise`` (the SRFlow NLL's global
    quantisation noise; else drawn from ``noise_seed`` for the global
    batch), ``nudge`` ((key, factor): that input scaled, for a spread),
    ``adam`` (take the step too), ``reps`` (steps timed after the first:
    'ms' is their median, else the first's; host clock around
    synchronised work) and ``data_norm``.  Returns {'mets', 'grads',
    'launches' (the first step's), 'ms', 'device' ('cpu' or 'cuda') [,
    'params', 'running' (BatchNorm running stats after the step)]}."""
    if kind not in STEPS:
        raise ValueError(f"kind {kind!r}: one of {STEPS}")
    opts = dict(opts or {})
    batch = dict(batch)
    if opts.get("noise") is not None:
        batch["noise"] = opts["noise"]
    models = models or build(kind, recipe, device, batch)
    if opts.get("nudge"):
        key, factor = opts["nudge"]
        batch[key] = batch[key] * factor
    mesh = None
    if mesh_axes:
        mesh = make_mesh(mesh_axes)
        # the trained module, and the VGG (the frozen flows keep their
        # kernel layouts, made from the same seed or state on every rank)
        for m in models[1 if kind != "srflow_nll" else 0:]:
            if m is not None:
                replicate(m)
        if kind == "srflow_nll":
            models[0].freeze()
        specs = (batch_specs_linf("sp" if "sp" in mesh_axes else None)
                 if kind == "linf" else batch_specs_srflow())
        if "noise" in batch:
            specs = dict(specs, noise=("dp",))
        if not local:
            batch = shard_batch(batch, mesh, specs)
    step, trained = make_step(kind, models, opts, mesh, device)
    data = _tensors(batch, device)
    noise = data.pop("noise", None)
    args = (0, noise) if kind == "srflow_nll" else ()
    _sync(device)
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = step.loss_and_grads(data, *args)
    launches = _launched(device)
    times = [(time.perf_counter() - t0) * 1e3]
    for _ in range(opts.get("reps", 0)):
        t0 = time.perf_counter()
        step.loss_and_grads(data, *args)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    if len(times) > 1:
        times = times[1:]
    result = {"mets": _np(out[0]), "grads": _np(out[1]),
              "launches": launches, "ms": float(np.median(times)),
              "device": torch.device(device).type}
    if opts.get("adam"):
        step(data, *args)
        result["params"] = _np(dict(trained.named_parameters()))
        result["running"] = _np({k: v for k, v in trained.named_buffers()
                                 if "running_" in k})
    return result


def run_predict(kind, recipe, inputs, mesh_axes, device, opts=None,
                models=None):
    """A sharded predict (see the module docstring), or, without
    ``mesh_axes``, the single predict of the whole input.  ``inputs``:
    'linf_sp' {inp (1, h, w, 3), coord (1, H, W, 2), cell (1, 2),
    gt_lr_up (1, H, W, 3)} (the whole grid; a rank keeps its rows);
    'linf_dp' the same with a batch of B and gt (B, H, W, 3); 'srflow_dp'
    {lr (B, h, w, 3)}; 'srflow_sp' {lr (h, w, 3)} (one image; a rank
    keeps its strip).  ``models``: ``build``'s, if the caller has them;
    ``opts`` (srflow_sp): ``kernels`` (as ``SRFlowLPPredictor``),
    ``mode`` (a precision mode for the predict), ``reps`` (predicts timed
    after the first: 'ms' is their median), ``stages`` (names of
    ``srflow_eval.STAGES`` whose outputs the first predict returns under
    'stages', for ``stage_errors``) and, without a mesh, ``sp`` (the
    strips whose padding the single predict takes).  Returns {'out'
    (the rank's part: for srflow_sp its SR strip of the padded image,
    unclipped; the whole padded SR without a mesh), 'launches', 'ms' [,
    'psnr'] [, 'image' (srflow_sp: the whole SR image, clipped and
    cropped), 'exchanges', 'bytes' (the first predict's halo exchanges
    and this rank's bytes in them)]}."""
    from bfsr_tpu_torch.pipelines.linf_eval import (LINFPredictor,
                                                    dp_psnr, predict_dp)
    from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor

    if kind not in PREDICTS:
        raise ValueError(f"kind {kind!r}: one of {PREDICTS}")
    models = models or build(kind, recipe, device)
    mesh = None
    if mesh_axes:
        mesh = make_mesh(mesh_axes)
        for m in models:
            if m is not None:
                replicate(m)
                m.freeze()
    data = _tensors(inputs, device)
    if kind == "srflow_sp":
        return _spatial_predict(models, data["lr"], mesh, device,
                                dict(opts or {}))
    if mesh is not None:
        # sp: the HR rows of the queries and the residual; dp: the images
        specs = ({"coord": (None, "sp"), "gt_lr_up": (None, "sp")}
                 if kind == "linf_sp" else {k: ("dp",) for k in data})
        data = shard_batch(data, mesh, specs)
    _sync(device)
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    result = {}
    if kind == "srflow_dp":
        pred = SRFlowLPPredictor(*models)
        out = torch.stack([pred.predict(x) for x in data["lr"]])
    else:
        linf, prior, _ = models
        pred = LINFPredictor(linf, prior)
        args = (data["inp"], data["coord"], data["cell"], data["gt_lr_up"])
        if kind == "linf_sp":
            out = (pred.predict_sharded(mesh, *args)
                   if mesh is not None else pred.predict(*args))
        else:
            out = predict_dp(pred, *args)
            if mesh is not None:
                result["psnr"] = float(dp_psnr(
                    mesh, torch.clamp(out, 0, 1), data["gt"]))
    result.update(out=out.detach().cpu().numpy(),
                  launches=_launched(device),
                  ms=(time.perf_counter() - t0) * 1e3)
    return result


def _spatial_predict(models, img, mesh, device, opts):
    """'srflow_sp' of ``run_predict``: with a mesh this rank's strip
    through ``SRFlowSpatialPredictor`` and the gathered image, without one
    ``SRFlowLPPredictor.run`` on the same padded LR."""
    from bfsr_tpu_torch.ops import nn as fnn
    from bfsr_tpu_torch.ops import halo
    from bfsr_tpu_torch.pipelines.srflow_eval import (SRFlowLPPredictor,
                                                      SRFlowSpatialPredictor,
                                                      pad_strips,
                                                      strip_multiple)

    model, prior = models
    kernels = opts.get("kernels", True)
    h, w = img.shape[:2]
    if mesh is not None:
        pred = SRFlowSpatialPredictor(model, prior, mesh, "sp", kernels)
        lr = pred.strip(pred.pad(img))

        def image(out):
            return pred.gather(out, h, w)
    else:
        pred = SRFlowLPPredictor(model, prior, kernels)
        lr = pad_strips(img, strip_multiple(opts.get("sp", 1), prior))

        def image(out):
            s = model.scale
            return torch.clamp(out[0], 0.0, 1.0)[: h * s, : w * s]
    saved = fnn.precision_mode()
    fnn.set_default_precision(opts.get("mode", saved))
    try:
        _sync(device)
        cuda.reset_launch_counts()
        halo.reset_exchange_counts()
        stages, keep = {}, opts.get("stages", ())

        def mark(stage, made):
            if stage in keep:
                made = ([made[k] for k in model.cond_keys()]
                        if stage == "rrdb" else made)
                stages[stage] = [t.detach().cpu().numpy() for t in (
                    made if isinstance(made, list) else [made])]

        t0 = time.perf_counter()
        out = pred.run(lr, mark)
        launches = _launched(device)
        moved = dict(halo.EXCHANGES)
        times = [(time.perf_counter() - t0) * 1e3]
        for _ in range(opts.get("reps", 0)):
            t0 = time.perf_counter()
            pred.run(lr)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        whole = image(out)
    finally:
        fnn.set_default_precision(saved)
    return {"out": out.detach().cpu().numpy(),
            "image": whole.detach().cpu().numpy(), "launches": launches,
            "ms": float(np.median(times[1:] or times)), "stages": stages,
            **moved}


def stage_errors(strip_stages, whole_stages, index, count):
    """{stage: the max abs difference of a rank's stage outputs (its
    strips; 'stages' of a 'srflow_sp' result) from the same columns of
    the single predict's}: where along the chain a strip leaves the
    whole image."""
    out = {}
    for stage, parts in strip_stages.items():
        errs = []
        for got, whole in zip(parts, whole_stages[stage]):
            w = whole.shape[2] // count
            want = whole[:, :, index * w:(index + 1) * w]
            errs.append(float(np.abs(got - want).max())
                        if got.shape == want.shape else float("inf"))
        out[stage] = max(errs)
    return out


def run_cases(cases, device):
    """Each of ``cases`` (dicts: 'step' or 'predict' naming the kind,
    'recipe', 'batch' / 'inputs', 'mesh', 'opts') in turn; their results
    as a list.  Steps of one kind and recipe that take no Adam step share
    one build of the models, and so do the spatial predicts of one seed
    recipe."""
    out, built = [], {}
    for c in cases:
        if "step" in c:
            opts = c.get("opts") or {}
            key = (c["step"], repr(sorted(c["recipe"].items())))
            models = None
            if not opts.get("adam") and "seed" in c["recipe"]:
                if key not in built:
                    built[key] = build(c["step"], c["recipe"], device,
                                       c["batch"])
                models = built[key]
            out.append(run_step(c["step"], c["recipe"], c["batch"],
                                c.get("mesh"), device, opts, models=models))
        else:
            models = None
            if c["predict"] == "srflow_sp" and "seed" in c["recipe"]:
                key = (c["predict"], repr(sorted(c["recipe"].items())))
                if key not in built:
                    built[key] = build(c["predict"], c["recipe"], device)
                models = built[key]
            out.append(run_predict(c["predict"], c["recipe"], c["inputs"],
                                   c.get("mesh"), device, c.get("opts"),
                                   models))
    return out


def rel_l2(got, ref):
    """Relative L2 error of ``got`` against ``ref`` (numpy)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


NUDGE = 1e-7
# the input each step's spread is taken under (scaled by 1 + NUDGE)
NUDGE_KEY = {"linf": "gt_lr_up", "srflow_nll": "LQ", "srflow_prior": "LQ"}
# The limits a sharded step is held to against the same step on one
# process.  Every metric within LOSS_RTOL relative.  Each gradient tensor,
# and all of them as one vector, within GRAD_FLOOR relative L2, or within
# SPREAD_FACTOR x the single-process step's own move under its input
# scaled by 1 + NUDGE where that is larger (a step whose gradients move
# more under a 1e-7 change of its input cannot be held closer: ReLU,
# max-pool and L1-sign decisions flip; the SRFlow-LP prior's second
# branch moves ~5e-5 at B 8 of 32^2), and never past GRAD_CAP, half the
# distance of a gradient of zeros.  On the CPU each tensor's own move
# sets its limit.  On the card cuDNN's weight-gradient sums are not
# reproducible from one run to the next, so a tensor's own move bounds
# none of its noise: every tensor is held to the worst tensor's move, at
# least 1e-3, as ``chip_smoke.py`` phases 10, 12 and 14 hold the kernel
# path to the twin path.  After Adam every parameter within PARAM_ATOL
# (``tests/test_sharded.py``'s limit: reduction-order noise that Adam's
# rsqrt amplifies where a second moment is near zero).
LOSS_RTOL, PARAM_ATOL, SPREAD_FACTOR, GRAD_CAP = 1e-5, 1e-3, 2.0, 0.5
GRAD_FLOOR = {"cpu": 1e-5, "cuda": 1e-3}


def _flat(grads, order):
    return np.concatenate([np.ravel(grads[k]) for k in order])


def _limits(single, nudged):
    """({tensor: limit}, the limit of all as one vector) for the
    single-process result ``single`` and its ``nudged`` runs."""
    ref = single["grads"]
    floor = GRAD_FLOOR[single["device"]]

    def limit(spread):
        return min(GRAD_CAP, max(floor, SPREAD_FACTOR * spread))

    spread = {k: max([rel_l2(n["grads"][k], g) for n in nudged], default=0.0)
              for k, g in ref.items()}
    if single["device"] == "cuda":
        spread = dict.fromkeys(spread, max(spread.values()))
    whole = max([rel_l2(_flat(n["grads"], ref), _flat(ref, ref))
                 for n in nudged], default=0.0)
    return {k: limit(v) for k, v in spread.items()}, limit(whole)


def compare_steps(single, ranks, label, nudged=()):
    """Hold each rank's ``run_step`` result against the single-process
    one, ``single``, to the limits above, with the spread of ``nudged``
    (the single-process step with its input scaled by a factor within
    NUDGE of 1; the largest move of the list): the metrics, the
    gradients, the parameters after Adam; and every rank's gradients and
    parameters the same as rank 0's.  Raises past a limit; returns a line
    for the log."""
    ref = single["grads"]
    tol, tol_all = _limits(single, nudged)
    worst_g, worst_p, worst_all = (0.0, ""), 0.0, 0.0
    for r, res in enumerate(ranks):
        for k, v in single["mets"].items():
            got = float(res["mets"][k])
            if not abs(got - float(v)) <= LOSS_RTOL * abs(float(v)):
                raise AssertionError(f"{label}: rank {r} {k} {got!r} vs "
                                     f"{float(v)!r} single-process")
        for k, g in ref.items():
            e = rel_l2(res["grads"][k], g)
            worst_g = max(worst_g, (e, k))
            if not e <= tol[k]:
                raise AssertionError(f"{label}: rank {r} gradient {k}: "
                                     f"relative L2 {e:.3e} > {tol[k]:.3e}")
            if not np.array_equal(res["grads"][k], ranks[0]["grads"][k]):
                raise AssertionError(f"{label}: rank {r} gradient {k} "
                                     "differs from rank 0's")
        e_all = rel_l2(_flat(res["grads"], ref), _flat(ref, ref))
        worst_all = max(worst_all, e_all)
        if not e_all <= tol_all:
            raise AssertionError(f"{label}: rank {r} gradients as one vector:"
                                 f" relative L2 {e_all:.3e} > {tol_all:.3e}")
        for k, p in single.get("params", {}).items():
            e = float(np.abs(res["params"][k] - p).max())
            worst_p = max(worst_p, e)
            if not e <= PARAM_ATOL:
                raise AssertionError(f"{label}: rank {r} parameter {k} after "
                                     f"Adam: max abs {e:.3e} > {PARAM_ATOL:g}")
            if not np.array_equal(res["params"][k], ranks[0]["params"][k]):
                raise AssertionError(f"{label}: rank {r} parameter {k} "
                                     "differs from rank 0's")
    loss = float(ranks[0]["mets"]["loss"])
    return (f"{label}: loss {loss!r} vs single-process "
            f"{float(single['mets']['loss'])!r}; {len(ref)} gradient tensors: "
            f"worst relative L2 {worst_g[0]:.3e} ({worst_g[1]}, at most "
            f"{tol.get(worst_g[1], tol_all):.3e}), all as one vector "
            f"{worst_all:.3e} (at most {tol_all:.3e})"
            + (f", parameters after Adam worst max abs {worst_p:.3e}"
               if "params" in single else "")
            + f"; {len(ranks)} ranks agree")


# a rank's SR strip of the spatial predict against the single predict's
# columns of the same padded LR (the CPU tests, the dry run, the card's
# kernel path): the sums take another order at a strip's width
STRIP_TOL = 1e-5


def compare_strips(single, ranks, label, tol=STRIP_TOL):
    """Each of ``ranks`` ('srflow_sp' results: one image's ``len(ranks)``
    strips, in order) against the same columns of ``single`` (the single
    predict of the same padded LR, ``run_predict`` without a mesh): its
    shape, and its max abs difference within ``tol`` (0: bitwise).
    Raises past it; returns the ranks' max abs differences."""
    parts = np.split(single["out"], len(ranks), axis=2)
    errs = []
    for r, (got, want) in enumerate(zip(ranks, parts)):
        if got["out"].shape != want.shape:
            raise AssertionError(f"{label}: rank {r} strip "
                                 f"{got['out'].shape}, expected {want.shape}")
        errs.append(float(np.abs(got["out"] - want).max()))
        if not errs[-1] <= tol:
            raise AssertionError(
                f"{label}: rank {r} strip max abs err {errs[-1]:.3e} > "
                f"{tol:g} against the single predict ({got['exchanges']} "
                "exchanges)")
    return errs


def check_against_single(case, ranks, label, device):
    """``compare_steps`` of the ranks' results of step ``case`` (a
    ``run_cases`` entry) against the single-process step, run here on
    ``device``, and its spread under the nudged input (``NUDGE_KEY``)."""
    single = run_cases([dict(case, mesh=None)], device)[0]
    opts = dict(case.get("opts") or {}, adam=False,
                nudge=(NUDGE_KEY[case["step"]], 1 + NUDGE))
    nudged = run_cases([dict(case, mesh=None, opts=opts)], device)[0]
    return compare_steps(single, ranks, label, [nudged])
