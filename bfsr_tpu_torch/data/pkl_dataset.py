"""``lrhr-pkl``: paired LR/HR pickles for SRFlow training (conf ``mode:
LRHR_PKL``), the counterpart of ``bfsr_tpu/data/pkl_dataset.py``.

Each pickle is a list of uint8 HWC crops (``prepare_data.py`` writes them);
a sample is ``{'GT', 'LQ'}`` as float32 in [0, 1], with an optional
random crop to ``gt_size`` (each axis on its own, aligned to the scale)
and an optional horizontal flip.  The draws come from Python's ``random``
in the JAX dataset's order, so one ``random.seed`` gives the same crops
and flips.
"""

import pickle
import random

import numpy as np

from bfsr_tpu_torch.registry import register


@register("lrhr-pkl")
class LRHRPkl:
    def __init__(self, dataroot_GT, dataroot_LQ, use_flip=False, n_max=None,
                 gt_size=None):
        with open(dataroot_GT, "rb") as f:
            self.hrs = pickle.load(f)
        with open(dataroot_LQ, "rb") as f:
            self.lqs = pickle.load(f)
        if len(self.hrs) != len(self.lqs):
            raise ValueError(f"{len(self.hrs)} GT crops but {len(self.lqs)} "
                             "LQ crops")
        if n_max:
            self.hrs, self.lqs = self.hrs[:n_max], self.lqs[:n_max]
        self.use_flip = use_flip
        self.gt_size = gt_size

    def __len__(self):
        return len(self.hrs)

    def __getitem__(self, idx):
        hr = np.asarray(self.hrs[idx], np.float32) / 255.0
        lq = np.asarray(self.lqs[idx], np.float32) / 255.0
        if self.gt_size and (hr.shape[0] > self.gt_size
                             or hr.shape[1] > self.gt_size):
            s = hr.shape[0] // lq.shape[0]
            gy = min(self.gt_size, hr.shape[0])
            gx = min(self.gt_size, hr.shape[1])
            y0 = random.randint(0, hr.shape[0] - gy)
            x0 = random.randint(0, hr.shape[1] - gx)
            y0 -= y0 % s
            x0 -= x0 % s
            hr = hr[y0: y0 + gy, x0: x0 + gx]
            lq = lq[y0 // s: (y0 + gy) // s, x0 // s: (x0 + gx) // s]
        if self.use_flip and random.random() < 0.5:
            hr = np.ascontiguousarray(hr[:, ::-1])
            lq = np.ascontiguousarray(lq[:, ::-1])
        return {"GT": hr, "LQ": lq}
