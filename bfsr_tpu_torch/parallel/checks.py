"""Rank functions that exercise the mesh, the collectives and the global
BatchNorm, for ``parallel.mesh.spawn``: each runs in every rank of a
group that is up and returns what that rank saw, for the caller to hold
against one process.

* ``mesh_layout(axes)``: this rank's coordinates and the ranks of each
  axis's group (each group's members all-gathered over it);
* ``collectives(values, sq_errors, pixel_counts)``: ``distributed_mean``
  and ``distributed_psnr`` of the rank's dp shard of each array;
* ``batch_norm_case(x, seed)``: one BatchNorm in its training form, inside
  ``fnn.data_parallel`` on the rank's dp shard of ``x``: the output, the
  statistics it returns, and the gradients of ``sum(y * w)`` (w drawn
  from ``seed``) with respect to the rank's x and the affine;
* ``dp_draws(seed, n)``: ``fnn.global_rows``'s rows of one global draw;
* ``replicate_case()``: ``replicate`` of a module and an optimizer that
  differ on every rank;
* ``fault(kind)``: a rank that fails, or hangs, while the others wait.

``run(calls)`` runs several in one rank.
"""

import time

import torch
import torch.distributed as dist
from torch import nn

from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.parallel.collective import (distributed_mean,
                                                distributed_psnr)
from bfsr_tpu_torch.parallel.mesh import make_mesh, shard_batch


def mesh_layout(axes):
    mesh = make_mesh(axes)
    members = {}
    for name in mesh.names:
        g = mesh.group(name)
        got = [torch.zeros(1, dtype=torch.int64)
               for _ in range(dist.get_world_size(g))]
        dist.all_gather(got, torch.tensor([mesh.rank]), group=g)
        members[name] = [int(t) for t in got]
    return {"rank": mesh.rank, "coords": mesh.coords, "members": members}


def collectives(values, sq_errors, pixel_counts):
    mesh = make_mesh({"dp": -1})
    local = shard_batch({"v": torch.from_numpy(values),
                         "se": torch.from_numpy(sq_errors),
                         "n": torch.from_numpy(pixel_counts)}, mesh,
                        {"v": ("dp",), "se": ("dp",), "n": ("dp",)})
    return {"mean": float(distributed_mean(mesh, local["v"])),
            "psnr": float(distributed_psnr(mesh, local["se"], local["n"]))}


def batch_norm_module(c, seed):
    """A BatchNorm2d over ``c`` channels with a random affine and running
    stats from ``seed``, and the weights ``w`` of the loss
    ``sum(y * w)`` (a function of ``seed`` and the shape)."""
    gen = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn, gen


def batch_norm_step(bn, x, w):
    """(y, (mean, unbiased var), grads of sum(y * w) wrt x, weight, bias),
    and the running stats after ``apply_bn_updates``'s fold at 0.1."""
    x = x.clone().requires_grad_(True)
    y, (mean, var) = fnn.batch_norm(x, bn, training=True)
    gx, gw, gb = torch.autograd.grad((y * w).sum(), [x, bn.weight, bn.bias])
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean)
        bn.running_var.mul_(0.9).add_(0.1 * var)
    return {"y": y.detach(), "mean": mean.detach(), "var": var.detach(),
            "gx": gx, "gweight": gw, "gbias": gb,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def batch_norm_case(x, seed):
    """This rank's part of a global BatchNorm over x (B, H, W, C), split
    over dp; ``w`` is drawn whole, the rank keeps its rows."""
    mesh = make_mesh({"dp": -1})
    bn, gen = batch_norm_module(x.shape[-1], seed)
    w = torch.randn(x.shape, generator=gen)
    local = shard_batch({"x": torch.from_numpy(x), "w": w}, mesh,
                        {"x": ("dp",), "w": ("dp",)})
    with fnn.data_parallel(mesh.group("dp"), mesh.index("dp"),
                           mesh.size("dp")):
        return batch_norm_step(bn, local["x"], local["w"])


def batch_norm_single(x, seed):
    """The same BatchNorm on one process over the whole x."""
    bn, gen = batch_norm_module(x.shape[-1], seed)
    w = torch.randn(x.shape, generator=gen)
    return {k: v.numpy() for k, v in
            batch_norm_step(bn, torch.from_numpy(x), w).items()}


def dp_draws(seed, n):
    """``fnn.global_rows`` under a dp scope: this rank's rows of one
    draw of ``n`` per rank from a generator seeded with ``seed``."""
    mesh = make_mesh({"dp": -1})
    gen = torch.Generator().manual_seed(seed)
    with fnn.data_parallel(mesh.group("dp"), mesh.index("dp"),
                           mesh.size("dp")):
        return fnn.global_rows(lambda m: torch.rand(m, generator=gen), n)


def global_draw(seed, n):
    return torch.rand(n, generator=torch.Generator().manual_seed(seed)).numpy()


def replicate_case():
    """A module and an Adam state that differ on every rank (drawn from
    the rank's seed, one step taken), then ``replicate``: this rank's
    parameters, buffers and optimizer state after it."""
    from bfsr_tpu_torch.parallel.mesh import replicate

    rank = dist.get_rank()
    bn, _ = batch_norm_module(4, seed=rank)
    opt = torch.optim.Adam(bn.parameters())
    (bn.weight * bn.bias).sum().backward()
    opt.step()
    replicate(bn, opt)
    state = [v for st in opt.state.values() for v in st.values()]
    return {"params": [p.detach() for p in bn.parameters()],
            "buffers": [b for b in bn.buffers()], "state": state}


def fault(kind):
    """A rank that fails while the others wait in a collective: 'raise'
    (the last rank raises, the others enter a barrier it never reaches)
    or 'hang' (rank 0 enters a barrier, the others sleep ten minutes)."""
    last = dist.get_world_size() - 1
    if kind == "raise" and dist.get_rank() == last:
        raise RuntimeError(f"rank {last} fails on purpose")
    if kind == "raise" or dist.get_rank() == 0:
        dist.barrier()
    else:
        time.sleep(600)


RANK_FNS = {f.__name__: f for f in (mesh_layout, collectives,
                                     batch_norm_case, dp_draws,
                                     replicate_case, fault)}


def run(calls):
    """Each (name of a rank function above, args) of ``calls`` in turn, in
    one rank; their results as a list (one spawn runs several)."""
    return [RANK_FNS[name](*args) for name, args in calls]
