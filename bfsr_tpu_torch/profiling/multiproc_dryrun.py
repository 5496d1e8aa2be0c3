"""Two-process loader-fed dry run of the LINF-LP dp step.

The twin of ``profiling/multihost_dryrun.py``.  Two ranks
(``torch.distributed`` over gloo on the CPU, ``parallel.mesh.spawn``)
each read their own shard of one dataset through
``data.sharded_loader.ShardedLoader`` (no shuffle: shard r is items 4r to
4r + 3) and feed it into one dp step of the LINF trainer (the tiny
flagship LINF, its UNet prior, the latent loss alone, Adam at 1e-3, as
the JAX dry run trains it).  The global loss and the updated parameters
are held against one process that runs the same global batch (the two
shards concatenated in rank order): the loss within 1e-5 relative and
every parameter within 1e-3 (``parallel.sharded.compare_steps``).  Green
means per-rank input pipelines, the global batch's semantics (global
BatchNorm statistics included) and the gradient all-reduce hold end to
end.

    python -m bfsr_tpu_torch.profiling.multiproc_dryrun
"""

import argparse

import numpy as np

N_PROC = 2
GLOBAL_B = 8
HW, SCALE = 6, 2
OPTS = {"vgg_weight": 0.0, "latent_weight": 1.0, "lr": 1e-3, "adam": True}


class Items:
    """A deterministic synthetic dataset of LINF training samples: item i
    is a function of i alone."""

    def __init__(self, n=GLOBAL_B):
        from bfsr_tpu_torch.utils.coords import make_cell, make_coord

        self.n = n
        H = HW * SCALE
        self.coord = make_coord((H, H), flatten=False)
        self.cell = make_cell((H, H))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(1000 + i)
        H = HW * SCALE
        return {"inp": r.random((HW, HW, 3)).astype(np.float32),
                "coord": self.coord, "cell": self.cell,
                "gt": r.random((H, H, 3)).astype(np.float32),
                "gt_lr_up": (r.random((H, H, 3)) - 0.5).astype(np.float32),
                "gt_pixel": (r.random((H, H, 3)) - 0.5).astype(np.float32)}


def _loader(shard_index=None, shard_count=None):
    from bfsr_tpu_torch.data.sharded_loader import ShardedLoader

    return ShardedLoader(Items(), batch_size=GLOBAL_B // N_PROC,
                         shuffle=False, num_workers=1,
                         shard_index=shard_index, shard_count=shard_count)


def rank_step():
    """One rank: its loader shard (the group's rank and size) into one dp
    step on a mesh of dp = the world.  Returns ``run_step``'s result."""
    import torch.distributed as dist

    from bfsr_tpu_torch.parallel.sharded import run_step

    out = run_step("linf", {"seed": 0, "tiny": True}, next(iter(_loader())),
                   {"dp": dist.get_world_size()}, "cpu", OPTS, local=True)
    out["indices"] = _loader().shard_indices(0).tolist()
    return out


def run(store_dir=None):
    """Spawn the two ranks, run the single-process step on the global
    batch, compare.  Returns the comparison's line; raises on a
    mismatch."""
    from bfsr_tpu_torch.parallel.mesh import spawn
    from bfsr_tpu_torch.parallel.sharded import compare_steps, run_step

    ranks = spawn(rank_step, N_PROC, "gloo", store_dir=store_dir)
    seen = [i for r in ranks for i in r["indices"]]
    if sorted(seen) != list(range(GLOBAL_B)):
        raise AssertionError(f"multiproc dry run: the shards read {seen}, "
                             f"not each of {GLOBAL_B} items once")
    shards = [next(iter(_loader(i, N_PROC))) for i in range(N_PROC)]
    batch = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    single = run_step("linf", {"seed": 0, "tiny": True}, batch, None, "cpu",
                      OPTS)
    return compare_steps(single, ranks, f"multiproc dry run ({N_PROC} "
                         f"processes, loader shards of {GLOBAL_B // N_PROC})")


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    print(run())
    print("MULTIPROC DRYRUN OK")


if __name__ == "__main__":
    main()
