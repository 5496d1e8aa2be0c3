"""A plain MLP (``mlp``): the counterpart of ``bfsr_tpu/models/mlp.py``
(the reference's ``LINF-LP/models/mlp.py``; no shipped config uses it,
it is part of the registry).  Linear layers with ReLU between them, over
the last axis of any input; every product follows the stage's
precision.

``state_dict`` keys are the reference's ``nn.Sequential``:
``layers.{0,2,..}``.
"""

from torch import nn

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.registry import register


@register("mlp")
class MLP(Model):
    registry_name = "mlp"

    def __init__(self, in_dim, out_dim, hidden_list):
        super().__init__()
        self.args = dict(in_dim=in_dim, out_dim=out_dim,
                         hidden_list=list(hidden_list))
        dims = [in_dim] + list(hidden_list) + [out_dim]
        layers = []
        for i in range(len(dims) - 1):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
            if i < len(dims) - 2:
                layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers)
        self.reset_parameters(seeded(0))

    def reset_parameters(self, generator):
        for m in self.layers:
            if isinstance(m, nn.Linear):
                fnn.init_linear_(m, generator)

    def forward(self, x):
        """x: (..., in_dim) -> (..., out_dim)."""
        linears = [m for m in self.layers if isinstance(m, nn.Linear)]
        h = x.reshape(-1, x.shape[-1])
        for i, lin in enumerate(linears):
            h = fnn.linear(h, lin.weight, lin.bias)
            if i < len(linears) - 1:
                h = fnn.relu(h)
        return h.reshape(*x.shape[:-1], -1)
