"""Rank functions for the halo path (``ops/halo.py``), for
``parallel.mesh.spawn``: every rank of a world that is up runs ``run``
and returns, for each case, its strip of the op's output, for the caller
to set side by side and hold against the op on the whole image.

A case is a dict: ``site`` (below), ``n`` (the first ``n`` ranks of the
world share the image; the others return None) and its numpy inputs,
whole.  A rank cuts its strip of each input (``strip``), runs the op of
``site`` inside ``ops.nn.width_sharded`` over its group, and returns the
output strip as a numpy array.  The sites:

* ``exchange`` {x, r}: ``halo.exchange`` itself (the haloed strip);
* ``unequal`` {x}: strips of unequal widths (rank ``i`` keeps ``i`` more
  columns): the error every rank raises, as text;
* ``conv2d`` {x, w, b}: ``ops.nn.conv2d``; ``grouped`` {x, w, groups}: a
  grouped SAME ``F.conv2d`` through ``halo.apply``, as the records'
  grouped conv runs;
* ``k3`` {xs, w, scale, bias, act, fn}: ``conv3x3_cat`` (fn 'kernel': the
  twin on a CPU tensor) or ``conv3x3_cat_twin`` (fn 'twin');
* ``records`` {ft, c, c_cond, hidden, n_steps, seed}:
  ``flows.cond_affine_cache_batched`` of ``flow_steps``' affines, each
  record cropped of the ``halo.STEP_HALO`` columns it keeps for its step;
* ``step`` {x, ft, c, c_cond, hidden, seed, reverse, fn, mode}: the
  records of ``flow_steps``' first step made inside the scope (with its
  halo), then ``flow_step_forward`` / ``_reverse``
  (fn 'kernel'), their ``_twin`` (fn 'twin') or the unfused
  ``FlowStep`` (fn 'unfused'), in precision ``mode``;
* ``resize`` {x, out_hw (whole), align_corners, nearest}: ``resize_bilinear``
  or ``resize_nearest``; ``upsample_to`` {x}: ``models.unet._upsample_to``
  to twice x's extent;
* ``pool`` {x}: ``ops.nn.max_pool2d``; ``squeeze`` / ``unsqueeze`` {x}:
  ``flows.squeeze2d`` / ``unsqueeze2d``.

A case with ``predict`` in place of ``site`` is a ``parallel.sharded``
case (``run_cases``), run in turn with the others.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bfsr_tpu_torch.models.srflow.flow_upsampler import FlowStep
from bfsr_tpu_torch.models.unet import _upsample_to
from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import conv3x3_cat, conv3x3_cat_twin
from bfsr_tpu_torch.ops.cuda.flow_step import (flow_step_forward,
                                               flow_step_forward_twin,
                                               flow_step_reverse,
                                               flow_step_reverse_twin)
from bfsr_tpu_torch.ops.interp import resize_bilinear, resize_nearest
from bfsr_tpu_torch.ops import halo
from bfsr_tpu_torch.parallel.sharded import run_cases


def strip(x, index, count, r=0):
    """Strip ``index`` of ``count`` of a whole-width tensor, with ``r``
    columns of each neighbour (``halo.sides``)."""
    w = x.shape[2] // count
    left, right = halo.sides(r, index, count)
    return x[:, :, index * w - left:(index + 1) * w + right].contiguous()


@torch.no_grad()
def flow_steps(c, c_cond, hidden, n_steps, seed):
    """``n_steps`` conditional ``FlowStep`` s (C ``c``, conditioning
    ``c_cond``, tower ``hidden``), every weight drawn from ``seed`` (live
    tails and actnorms, an orthogonal invconv), frozen in the ``xla``
    form."""
    gen = torch.Generator().manual_seed(seed)
    steps = []
    for _ in range(n_steps):
        m = FlowStep(c, c_cond, hidden)
        for name, p in m.named_parameters():
            if "invconv" in name:
                q, r = torch.linalg.qr(torch.randn(p.shape, generator=gen))
                p.copy_(q * torch.sign(torch.diagonal(r))[None, :])
            else:
                std = 0.3 / max(1, p[0].numel()) ** 0.5 if p.ndim == 4 else 0.1
                p.copy_(torch.randn(p.shape, generator=gen) * std)
        m.freeze("xla")
        steps.append(m)
    return steps


def _tensor(v):
    if isinstance(v, list):
        return [_tensor(t) for t in v]
    return torch.as_tensor(v) if hasattr(v, "shape") else v


def _grouped(x, w, groups):
    return fnn.nchw_to_nhwc(F.conv2d(fnn.nhwc_to_nchw(x), w, padding=1,
                                     groups=groups))


def _site(a, index, count):
    """The op of case ``a`` on this rank's strips (inside the scope)."""
    site = a["site"]
    if site == "exchange":
        return halo.exchange(strip(a["x"], index, count), a["r"],
                             *fnn.width_shard())
    if site == "conv2d":
        return fnn.conv2d(strip(a["x"], index, count), a["w"], a["b"])
    if site == "grouped":
        return halo.apply(lambda h: _grouped(h, a["w"], a["groups"]), 1,
                          [strip(a["x"], index, count)])
    if site == "k3":
        fn = conv3x3_cat if a["fn"] == "kernel" else conv3x3_cat_twin
        return fn([strip(x, index, count) for x in a["xs"]], a["w"],
                  a["scale"], a["bias"], a["act"])
    if site == "records":
        steps = flow_steps(a["c"], a["c_cond"], a["hidden"], a["n_steps"],
                           a["seed"])
        return torch.stack([halo.crop(r, halo.STEP_HALO, index, count)
                            for r in flows.cond_affine_cache_batched(
                                strip(a["ft"], index, count),
                                [m.affine for m in steps])])
    if site == "step":
        (m,) = flow_steps(a["c"], a["c_cond"], a["hidden"], 1, a["seed"])
        saved = fnn.precision_mode()
        fnn.set_default_precision(a["mode"])
        try:
            (rec,) = flows.cond_affine_cache_batched(
                strip(a["ft"], index, count), [m.affine])
            x = strip(a["x"], index, count)
            if a["fn"] == "unfused":
                return (m.reverse_step(x, rec, False) if a["reverse"]
                        else m.forward_step(x, rec, False))
            fns = {("kernel", False): flow_step_forward,
                   ("kernel", True): flow_step_reverse,
                   ("twin", False): flow_step_forward_twin,
                   ("twin", True): flow_step_reverse_twin}
            return fns[a["fn"], a["reverse"]](x, rec, m.kpacked, m.hidden,
                                              m.kpacked_bf16, m.step_form)
        finally:
            fnn.set_default_precision(saved)
    x = strip(a["x"], index, count)
    if site == "resize":
        hw = (a["out_hw"][0], a["out_hw"][1] // count)
        if a["nearest"]:
            return resize_nearest(x, hw)
        return resize_bilinear(x, hw, a["align_corners"])
    if site == "upsample_to":
        return _upsample_to(x, (2 * x.shape[1], 2 * x.shape[2]))
    if site == "pool":
        return fnn.max_pool2d(x, 2)
    if site == "squeeze":
        return flows.squeeze2d(x)
    if site == "unsqueeze":
        return flows.unsqueeze2d(x)
    raise ValueError(f"site {site!r}")


def _unequal(a, group, index, count):
    """Strips that differ in width: the exchange's error, as text."""
    w = a["x"].shape[2] // count
    x = a["x"][:, :, :w + index]
    try:
        halo.exchange(x, 1, group, index, count)
    except ValueError as e:
        return str(e)
    return "no error"


def run(cases, device="cpu"):
    """Each case in turn on this rank (see the module docstring); their
    results as a list."""
    world, rank = dist.get_world_size(), dist.get_rank()
    # the group of the first n ranks, for each n a case names (every rank
    # makes every group, in the same order)
    groups = {n: dist.new_group(list(range(n)))
              for n in sorted({c["n"] for c in cases if "site" in c})
              if n <= world}
    out = []
    for c in cases:
        if "predict" in c:
            out.append(run_cases([c], device)[0])
            continue
        n = c["n"]
        if rank >= n:
            out.append(None)
            continue
        a = {k: _tensor(v) for k, v in c.items()}
        if c["site"] == "unequal":
            out.append(_unequal(a, groups[n], rank, n))
            continue
        with torch.no_grad(), fnn.width_sharded(groups[n], rank, n):
            out.append(_site(a, rank, n).cpu().numpy())
    return out
