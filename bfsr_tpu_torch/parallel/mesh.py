"""A (dp, sp) mesh over a ``torch.distributed`` world, and how ranks start.

The counterpart of ``bfsr_tpu/parallel/mesh.py``.  The JAX package lays
its devices out as a named mesh and lets GSPMD place the collectives;
here every process is one rank, and a mesh is the rank's coordinates on
the named axes plus one process group per axis (the ranks that differ
from this one on that axis alone):

* **dp**: batch data parallelism (the batch split, the trainable
  weights replicated, their gradients averaged over dp, BatchNorm's
  statistics global over dp);
* **sp**: query parallelism (the HR query rows split; the LINF steps
  gather what the trainable part reads over sp).

``make_mesh({'dp': a, 'sp': b})`` lays the world out row-major in the
axes' order, as ``np.reshape`` lays the JAX devices: rank = i_dp * b +
i_sp.  ``replicate`` broadcasts a module's parameters and buffers, and
an optimizer's state, from rank 0; ``shard_batch`` keeps this rank's
slice of each array under its spec (a tuple of axis names or None per
leading dimension, as a ``PartitionSpec``).

``spawn(fn, world, backend)`` starts ``world`` ranks with
``torch.multiprocessing`` (the spawn method) on a ``file://`` store,
calls ``fn(*args)`` in each, with a process group up, and
returns each rank's result.  ``fn`` is pickled by name, so it must live
in an importable module: a spawned child imports it and nothing of the
caller's ``__main__`` but what ``multiprocessing`` imports itself.  The
group has an explicit init timeout, the join has a timeout, and a rank
that fails, or the join's timeout, kills every rank.  The caller names
the backend (``gloo`` or ``nccl``); nothing here switches it.
"""

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """This rank's place on named axes: ``size(axis)``, ``index(axis)``
    and ``group(axis)`` (the ranks that differ from this one on ``axis``
    alone, ordered by their index on it)."""

    def __init__(self, names, sizes, rank, groups):
        self.names, self.sizes = tuple(names), tuple(sizes)
        self.rank = rank
        self._groups = groups
        coords = np.unravel_index(rank, self.sizes)
        self.coords = {n: int(c) for n, c in zip(self.names, coords)}

    def size(self, axis):
        return self.sizes[self.names.index(axis)] if axis in self.names else 1

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        if axis not in self.names:
            raise KeyError(f"the mesh has axes {self.names}, not {axis!r}")
        return self._groups[axis]


def mesh_sizes(axes, world):
    """The axes' sizes for a world of ``world`` ranks: ``-1`` (at most one)
    takes what the others leave; the sizes must multiply to ``world``."""
    names, sizes = list(axes), list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one axis may be -1: {axes}")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if world % known:
            raise ValueError(f"axes {axes} do not divide a world of {world}")
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world or min(sizes) < 1:
        raise ValueError(f"axes {dict(zip(names, sizes))} multiply to "
                         f"{int(np.prod(sizes))}, not the world's {world}")
    return names, sizes


def make_mesh(axes):
    """The mesh of dict ``axes`` (name -> size, one may be -1) over the
    process group that is up.  Every rank must call it, with the same
    axes: each axis's groups are made with ``dist.new_group``, which the
    whole world calls in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group (init_process_group, or spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    names, sizes = mesh_sizes(axes, world)
    grid = np.arange(world).reshape(sizes)
    groups = {}
    for ax, name in enumerate(names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(names, sizes, rank, groups)


def _broadcast(tensors, src=0):
    """Broadcast each tensor in place from ``src`` over the world.  Under
    ``nccl`` a CPU tensor (an optimizer's step count) goes through a CUDA
    copy: nccl moves CUDA tensors only."""
    nccl = dist.get_backend() == "nccl"
    for t in tensors:
        if nccl and t.device.type != "cuda":
            buf = t.to("cuda")
            dist.broadcast(buf, src)
            t.copy_(buf.to(t.device))
        else:
            dist.broadcast(t, src)


@torch.no_grad()
def replicate(module, optimizer=None, src=0):
    """Broadcast ``module``'s parameters and buffers, and ``optimizer``'s
    state tensors, from rank ``src``, in place: every rank then holds rank
    ``src``'s.  Returns the module."""
    _broadcast([*module.parameters(), *module.buffers()], src)
    if optimizer is not None:
        state = [v for s in optimizer.state.values() for v in s.values()
                 if torch.is_tensor(v)]
        _broadcast(state, src)
    return module


def shard_batch(batch, mesh, specs):
    """This rank's slice of each array of ``batch`` (numpy or tensors):
    ``specs[key]`` is a tuple of axis names or None, one per leading
    dimension; a missing key, or None, keeps the dimension whole.  A
    dimension that an axis's size does not divide raises."""
    out = {}
    for k, v in batch.items():
        for dim, axis in enumerate(specs.get(k) or ()):
            if axis is None or mesh.size(axis) == 1:
                continue
            n, size = v.shape[dim], mesh.size(axis)
            if n % size:
                raise ValueError(f"{k}: dimension {dim} of {tuple(v.shape)} "
                                 f"does not divide over {axis}={size}")
            i, part = mesh.index(axis), n // size
            idx = (slice(None),) * dim + (slice(i * part, (i + 1) * part),)
            v = v[idx]
        out[k] = v
    return out


def batch_specs_srflow():
    """Specs of an SRFlow training batch (GT/LQ pairs): the batch over dp,
    the reference's only parallel axis (``SRFlow_model.py:42-53``)."""
    return {"GT": ("dp",), "LQ": ("dp",)}


def batch_specs_linf(sp=None):
    """Specs of a LINF-LP training batch: the batch over dp and, with
    ``sp``, the HR query rows over sp."""
    return {"inp": ("dp",), "coord": ("dp", sp), "cell": ("dp",),
            "gt": ("dp", sp), "gt_lr_up": ("dp", sp),
            "gt_pixel": ("dp", sp), "gt_patch": ("dp", sp),
            "interpolate_coord": ("dp", sp)}


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def _to_host(x):
    """Tensors in a result as numpy arrays: a child's CUDA tensors cannot
    outlive it, and CPU ones would travel through shared memory."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, world, backend, init_method, init_timeout, threads,
               device, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=init_timeout))
        out = pickle.dumps(_to_host(fn(*args)))
    except BaseException:
        # reported to the parent, which stops every rank, before this
        # rank's exit closes its connections, so that its error reaches
        # the parent ahead of the others' it causes
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.destroy_process_group()
    results.put((rank, True, out))


def spawn(fn, world, backend="gloo", args=(), store_dir=None,
          init_timeout=60.0, join_timeout=300.0, threads=None, device=None):
    """Run ``fn(*args)`` on ``world`` new ranks, each with a process group
    of ``backend`` up (a ``file://`` store in ``store_dir``, a fresh
    temporary directory by default), and return their results in rank
    order (tensors as numpy arrays).  ``threads``: each rank's torch
    intra-op threads (default: the cores shared out); ``device``: the
    CUDA device each rank selects before the group is made (nccl needs
    one).  ``init_timeout`` bounds the group's init and every collective;
    ``join_timeout`` the whole run.  A rank that raises, or the join's
    timeout, terminates every rank and raises here with the rank's
    traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    made = None if store_dir else tempfile.mkdtemp(prefix="bfsr_dist_")
    store_dir = Path(store_dir or made)
    store = store_dir / f"store_{os.getpid()}_{time.monotonic_ns()}"
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, f"file://{store}",
                               init_timeout, threads, device, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + join_timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world - len(out)} of {world} "
                                   f"ranks of {fn.__qualname__} did not "
                                   f"finish in {join_timeout:g} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if not dead:
                    continue
                try:  # a rank that raised has sent its traceback first
                    rank, ok, payload = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} of {fn.__qualname__} died "
                        f"with exit code {procs[dead[0]].exitcode}") from None
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of {fn.__qualname__} "
                                   f"failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if store.exists():
            store.unlink()
        if made:
            shutil.rmtree(made, ignore_errors=True)
    return [out[r] for r in range(world)]
