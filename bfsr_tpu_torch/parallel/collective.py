"""Collectives over a mesh axis's ``torch.distributed`` group.

The counterpart of ``bfsr_tpu/parallel/collective.py``
(``distributed_mean``, ``distributed_psnr``: one reduction of partial
sums over the dp axis, then the division or the log on replicated
values), and the collectives the sharded steps are built from (the
differentiable sum of the global BatchNorm statistics is
``ops.nn.all_reduce_sum``, beside the BatchNorm that reads it):

* ``gather_rows``: a plain ``all_gather`` along an axis, no gradient,
  for frozen values (the LINF step's sp gather of z and the info);
* ``average_tensors``: one all-reduce of every gradient, flattened,
  divided by the group's size;
* ``mean_over``: the mean of a few scalars over a group (a step's
  metrics), on the device.

Every call takes tensors on the device its group's backend serves
(``nccl``: CUDA; ``gloo``: CPU, or CUDA for these collectives, which gloo
stages through the host).  Nothing here switches a backend or a device.
"""

import torch
import torch.distributed as dist


def _size(group):
    return dist.get_world_size(group)


@torch.no_grad()
def gather_rows(x, group, dim=1):
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order of ``group``: one ``all_gather``, no gradient."""
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


@torch.no_grad()
def average_tensors(tensors, group):
    """Replace each tensor, in place, by its mean over ``group``: one
    all-reduce of them all, flattened."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= _size(group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def mean_over(values, group):
    """{name: scalar tensor} -> {name: scalar tensor}, each the mean over
    ``group`` (one all-reduce, no host fetch)."""
    names = list(values)
    v = torch.stack([values[k].detach().float() for k in names])
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    return dict(zip(names, v / _size(group)))


@torch.no_grad()
def distributed_mean(mesh, values, axis_name="dp"):
    """Mean of per-example scalars sharded over ``axis_name``: values (n,)
    this rank's; one all-reduce of (sum, count), then the division on
    the replicated totals.  Returns a scalar tensor, the same on every
    rank."""
    part = torch.stack([values.float().sum(),
                        torch.tensor(float(values.shape[0]),
                                     device=values.device)])
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.group(axis_name))
    return part[0] / part[1]


@torch.no_grad()
def distributed_psnr(mesh, sq_errors, pixel_counts, axis_name="dp"):
    """PSNR over a dp-sharded eval: one all-reduce of this rank's
    squared-error and pixel-count partial sums, then one log on the
    replicated totals."""
    part = torch.stack([sq_errors.float().sum(), pixel_counts.float().sum()])
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.group(axis_name))
    return -10.0 * torch.log10(part[0] / part[1])
