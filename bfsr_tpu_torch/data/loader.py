"""Batched data loader with thread prefetch: the counterpart of
``bfsr_tpu/data/loader.py``.

Worker threads run the dataset (numpy and PIL, which release the GIL in
their hot loops) and stack each batch's samples into a dict of numpy
arrays; batches come out in order, up to PREFETCH of them ready ahead.
The shuffle draws from ``np.random.default_rng(seed)``, once per epoch.
"""

import queue
import threading

import numpy as np

PREFETCH = 4


def stack(samples):
    """A list of sample dicts -> one dict of arrays with a batch axis."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 num_workers=4, seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        end = len(self) * self.batch_size if self.drop_last else len(idx)
        return [idx[i:i + self.batch_size]
                for i in range(0, end, self.batch_size)]

    def __iter__(self):
        batches = self._batches()
        done = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        todo = iter(enumerate(batches))
        todo_lock = threading.Lock()

        def worker():
            while not stop.is_set():
                with todo_lock:
                    try:
                        bi, batch_idx = next(todo)
                    except StopIteration:
                        return
                try:
                    result = stack([self.dataset[int(i)] for i in batch_idx])
                except Exception as e:  # raised in the consumer
                    result = e
                # a bounded put that re-checks stop, so that a consumer
                # that quits early never leaves a worker blocked
                while not stop.is_set():
                    try:
                        done.put((bi, result), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending = {}
            for want in range(len(batches)):
                while want not in pending:
                    bi, result = done.get()
                    pending[bi] = result
                item = pending.pop(want)
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
