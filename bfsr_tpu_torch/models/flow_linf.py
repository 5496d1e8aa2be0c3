"""Registered 'flow' model: the LINF pointwise flow as a module.

The counterpart of ``bfsr_tpu/models/flow_linf.py``: d = 3 ps^2, 3 for
the pixel model and 27 for the ps = 3 patch model.  ``state_dict`` keys
are the reference's (``linears.{i}._weight``, ``linears.{i}.bias``,
``last._weight``, ``last.bias``).  ``freeze()`` stacks the weights and
caches the float64 inverses as non-persistent buffers, so a reference
checkpoint still loads; call it again after changing the weights.
"""

import math

import torch
from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import pointwise_flow as pwf
from bfsr_tpu_torch.registry import register


class NaiveLinear(nn.Module):
    def __init__(self, d):
        super().__init__()
        self._weight = nn.Parameter(torch.empty(d, d))
        self.bias = nn.Parameter(torch.zeros(d))


@register("flow")
class Flow(Model):
    registry_name = "flow"

    def __init__(self, flow_layers=10, patch_size=1, name="flow"):
        super().__init__()
        self.args = dict(flow_layers=flow_layers, patch_size=patch_size,
                         name=name)
        self.n_layers = flow_layers
        self.dim = 3 * patch_size * patch_size
        self.linears = nn.ModuleList([NaiveLinear(self.dim)
                                      for _ in range(flow_layers)])
        self.last = NaiveLinear(self.dim)
        for name_ in ("w", "b", "w_inv", "logabsdet"):
            self.register_buffer(name_, None, persistent=False)
        self.reset_parameters(seeded(0))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """U(+-1/sqrt(8)) weights, zero biases (the reference init)."""
        stdv = 1.0 / math.sqrt(8)
        for lin in [*self.linears, self.last]:
            lin._weight.uniform_(-stdv, stdv, generator=generator)
            lin.bias.zero_()

    @torch.no_grad()
    def freeze(self):
        """Stack the weights and cache W^-1 and log|det W| (float64)."""
        lins = [*self.linears, self.last]
        p = pwf.cache_inverses({
            "w": torch.stack([m._weight for m in lins]).detach(),
            "b": torch.stack([m.bias for m in lins]).detach()})
        for k, v in p.items():
            setattr(self, k, v.contiguous())
        return self

    def params(self):
        """The frozen parameter dict of ``ops.pointwise_flow``."""
        if self.w_inv is None:
            raise RuntimeError("Flow.freeze() has not been called")
        return {"w": self.w, "b": self.b, "w_inv": self.w_inv,
                "logabsdet": self.logabsdet}

    def forward(self, x, affine_info):
        """(z, log_p) for x (N, d), affine_info (N, 2dL)."""
        return pwf.forward(self.params(), x, affine_info)

    def inverse(self, z, affine_info):
        return pwf.inverse(self.params(), z, affine_info)
