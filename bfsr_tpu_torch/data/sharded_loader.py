"""A loader for data-parallel training: each rank reads its own disjoint
slice of one global shuffle.

The counterpart of ``bfsr_tpu/data/grain_loader.py`` (``GrainLoader``),
without grain: the order is this module's own permutation, not grain's.
Each ``iter()`` is one epoch.  The epoch's permutation of the dataset's
indices is drawn from ``np.random.default_rng(seed + epoch)`` (or is the
identity without ``shuffle``), the same on every rank; shard ``i`` of
``count`` takes its ``i``-th contiguous slice of ``n // count`` indices,
so the shards are disjoint and, when ``count`` divides ``n``, together
the whole dataset.  As grain yields it, every shard has ``n // count``
records whatever the remainder (the ``n % count`` extras never surface),
so every rank takes the same number of steps: ``len`` is that count over
the batch, rounded up, or down with ``drop_last``.  Batches are stacked
and prefetched by ``data.loader.DataLoader``'s worker threads.

``shard_index`` / ``shard_count`` default to ``dist.get_rank()`` /
``dist.get_world_size()`` when a process group is up, and to 0 / 1
otherwise.
"""

import numpy as np
import torch.distributed as dist

from bfsr_tpu_torch.data.loader import DataLoader


class _Indexed:
    """The dataset at a list of indices."""

    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


class ShardedLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 num_workers=4, seed=0, shard_index=None, shard_count=None):
        if shard_index is None or shard_count is None:
            up = dist.is_available() and dist.is_initialized()
            shard_index = dist.get_rank() if up else 0
            shard_count = dist.get_world_size() if up else 1
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = int(seed or 0)
        self.shard = (shard_index, shard_count)
        self.epoch = 0

    def shard_indices(self, epoch):
        """This shard's dataset indices in epoch ``epoch``, in order."""
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed + epoch).permutation(n)
                 if self.shuffle else np.arange(n))
        per = n // self.shard[1]
        return order[self.shard[0] * per:(self.shard[0] + 1) * per]

    def __len__(self):
        per = len(self.dataset) // self.shard[1]
        if self.drop_last:
            return per // self.batch_size
        return -(-per // self.batch_size)

    def __iter__(self):
        indices = self.shard_indices(self.epoch)
        self.epoch += 1
        return iter(DataLoader(_Indexed(self.dataset, indices),
                               batch_size=self.batch_size,
                               drop_last=self.drop_last,
                               num_workers=self.num_workers))
