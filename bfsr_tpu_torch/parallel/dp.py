"""The data-parallel side of one train step over a mesh's dp axis.

``DataParallel(mesh)`` gives a step its dp group's operations, each the
identity where there is no dp group (no mesh, or a mesh without a ``dp``
axis, such as an sp-only one):

* ``scope()``: the trainable part's ``fnn.data_parallel`` scope (global
  BatchNorm statistics, global per-sample draws);
* ``average(tensors)`` / ``average_grads(params)``: the gradients'
  mean over the group, one all-reduce; with an sp axis of more than one
  rank, then their mean over sp too.  The sp ranks compute one gradient
  on the same gathered values, equal in exact arithmetic, but on the card
  cuDNN's weight-gradient sums are not bitwise reproducible from one
  process to the next, and replicas whose steps differ in the last bit
  drift apart; the mean keeps every rank's step the same;
* ``metric_tensors(mets)``: the metric tensors' mean over the group, on
  the device; ``metrics(mets)`` the same as floats (one host fetch).
"""

import contextlib

import torch

from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.parallel.collective import average_tensors, mean_over


class DataParallel:
    def __init__(self, mesh=None):
        on = mesh is not None and "dp" in mesh.names
        self.group = mesh.group("dp") if on else None
        self.index = mesh.index("dp") if on else 0
        self.count = mesh.size("dp") if on else 1
        self.sp = (mesh.group("sp") if mesh is not None
                   and mesh.size("sp") > 1 else None)
        self.grad_groups = [g for g in (self.group, self.sp)
                            if g is not None]

    def scope(self):
        if self.group is None:
            return contextlib.nullcontext()
        return fnn.data_parallel(self.group, self.index, self.count)

    def average(self, tensors):
        tensors = list(tensors)
        for g in self.grad_groups:
            average_tensors(tensors, g)

    def average_grads(self, params):
        """Each parameter's ``.grad`` (where it has one: every rank agrees
        on which) by ``average``."""
        self.average(p.grad for p in params if p.grad is not None)

    def metric_tensors(self, mets):
        if self.group is not None:
            return mean_over(mets, self.group)
        return {k: v.detach() for k, v in mets.items()}

    def metrics(self, mets):
        mets = self.metric_tensors(mets)
        return dict(zip(mets, torch.stack(list(mets.values())).tolist()))
