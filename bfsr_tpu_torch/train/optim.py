"""Optimizers and LR schedules: the counterpart of
``bfsr_tpu/train/optim.py`` (optax) in ``torch.optim``.

* ``make_optimizer(spec, params)`` builds the reference's ``adam`` / ``sgd``
  specs.  ``torch.optim.Adam`` divides by ``sqrt(v_hat) + eps``, with eps
  outside the root, which is optax's ``adam`` update; ``weight_decay`` is
  torch's coupled L2 (the decay added to the gradient before the moments),
  which the JAX package builds as ``add_decayed_weights`` ahead of adam.
* Each schedule is a function of the number of updates already taken
  (0 for the first), returning the learning rate, as an optax schedule
  reads its count.  ``lr_scheduler(optimizer, schedule, base_lr)`` wraps
  one as a ``LambdaLR`` stepped once per iteration, after
  ``optimizer.step()``: update k then runs at ``schedule(k - 1)``.
"""

import math

import torch


def multi_step_lr(base_lr, milestones, gamma=0.5):
    """lr = base * gamma ** (number of milestones <= count)."""
    milestones = sorted(milestones)

    def schedule(count):
        return base_lr * gamma ** sum(count >= m for m in milestones)

    return schedule


def multi_step_restart(base_lr, milestones, gamma=0.5, restarts=(),
                       restart_weights=()):
    """MultiStepLR_Restart: at a restart r the lr resets to ``base_lr *
    weight``; each milestone after the last restart multiplies by
    ``gamma`` (a milestone on a restart is swallowed by the reset)."""
    milestones = sorted(milestones)
    order = sorted(range(len(restarts)), key=lambda i: restarts[i])
    restarts = [restarts[i] for i in order]
    weights = [restart_weights[i] for i in order]

    def schedule(step):
        w, last = 1.0, 0
        for r, rw in zip(restarts, weights):
            if step >= r:
                w, last = rw, r
        n = sum(step >= m and m > last for m in milestones)
        return base_lr * w * gamma ** n

    return schedule


def cosine_restart(base_lr, t_period, eta_min=1e-7, restarts=(),
                   restart_weights=()):
    """CosineAnnealingLR_Restart in closed form: segment i spans
    [restarts[i-1], restarts[i]) with period ``t_period[i]`` and amplitude
    ``base_lr * restart_weights[i-1]`` (segment 0: weight 1); past its
    period a segment's amplitude is the unweighted ``base_lr - eta_min``,
    as the torch scheduler's wrap branch makes it."""
    periods = [float(p) for p in t_period]
    restarts = list(restarts)
    if restarts != sorted(restarts) or len(set(restarts)) != len(restarts):
        raise ValueError(f"restarts must be strictly increasing: {restarts}")
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and their weights do not match.")
    if len(periods) < len(restarts) + 1:
        raise ValueError(f"need len(T_period) >= len(restarts)+1 "
                         f"({len(periods)} < {len(restarts) + 1})")
    starts = [0.0] + [float(r) for r in restarts]
    weights = [1.0] + [float(w) for w in restart_weights]

    def schedule(step):
        i = sum(step >= s for s in starts[1:])
        t, period = step - starts[i], periods[i]
        amp = (base_lr * weights[i] if t <= period else base_lr) - eta_min
        return eta_min + 0.5 * amp * (1.0 + math.cos(math.pi * t / period))

    return schedule


def with_warmup(schedule, base_lr, warmup_iter):
    """Linear warmup: below ``warmup_iter`` the lr is ``base_lr * step /
    warmup_iter`` whatever the schedule; ``warmup_iter`` <= 0 or None
    leaves the schedule as it is."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def wrapped(step):
        if step < warmup_iter:
            return base_lr * step / warmup_iter
        return schedule(step)

    return wrapped


def make_optimizer(spec, params):
    """spec: {'name': 'adam' | 'sgd', 'args': {torch kwargs, 'lr' required}}."""
    args = dict(spec.get("args") or {})
    lr = args.pop("lr")
    wd = args.pop("weight_decay", 0.0)
    if spec["name"] == "adam":
        return torch.optim.Adam(params, lr=lr,
                                betas=tuple(args.pop("betas", (0.9, 0.999))),
                                eps=args.pop("eps", 1e-8), weight_decay=wd)
    if spec["name"] == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=args.pop("momentum", 0.0),
                               weight_decay=wd)
    raise ValueError(spec["name"])


def clip_by_global_norm(optimizer, max_norm):
    """``optimizer``, each of whose steps first scales every gradient by
    ``max_norm / max(norm, max_norm)``, the norm the global L2 norm over
    every parameter that has a gradient, no epsilon: optax's
    ``clip_by_global_norm`` (``(g / norm) * max_norm`` where norm >=
    max_norm), up to the rounding of the one factor;
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.  Below
    the limit the factor is exactly 1.  A step pre-hook: the trainers and
    ``lr_scheduler`` take the optimizer as before, and nothing waits on
    the host for the norm."""
    def clip(opt, args, kwargs):
        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            norm = torch.nn.utils.get_total_norm(grads)
            torch._foreach_mul_(grads, max_norm / torch.clamp(norm,
                                                              min=max_norm))

    optimizer.register_step_pre_hook(clip)
    return optimizer


def share_step_count(optimizer):
    """Before ``optimizer.step()``: each parameter that has a gradient but
    no state yet gets zero moments and the step count of the others (the
    largest), as if it had taken zero gradients at every step so far (the
    JAX trainers' masked gradients under optax's shared count).  A no-op
    before the first step."""
    new = [p for group in optimizer.param_groups for p in group["params"]
           if p.grad is not None and not optimizer.state.get(p)]
    if not new:
        return
    states = [st for st in optimizer.state.values() if "step" in st]
    if not states:
        return
    count = max(st["step"] for st in states)
    for p in new:
        optimizer.state[p] = {
            k: count.clone() if k == "step" else torch.zeros_like(
                p, memory_format=torch.preserve_format)
            for k in states[0]}


def lr_scheduler(optimizer, schedule, base_lr, count=0):
    """``schedule`` as a ``LambdaLR`` over ``optimizer``, stepped once per
    iteration; ``count``: the updates already taken (a resumed run), so
    that the next update runs at ``schedule(count)``."""
    for group in optimizer.param_groups:
        group["initial_lr"] = base_lr
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / base_lr,
        last_epoch=count - 1)
