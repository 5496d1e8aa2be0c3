"""LPIPS, the perceptual metric with an AlexNet backbone: the counterpart
of ``bfsr_tpu/models/lpips.py`` (the published ``lpips`` package's
architecture, which the reference scores with).

A fixed input scaling, AlexNet's conv features tapped after each of its
five ReLUs, each tap unit-normalised over channels, the squared
difference of the two images' taps weighted by a 1x1 ``lin`` head, the
spatial mean, and the sum over taps.  The normalisation is the JAX
package's, x rsqrt(sum x^2 + 1e-10).  The convs are library convs (the
JAX package's are XLA convs; neither has a kernel of its own).

``state_dict`` keys are the published package's: ``scaling_layer.shift``
/ ``.scale``, ``net.slice{1..5}.{i}.weight`` / ``.bias`` (torchvision's
AlexNet indices) and ``lin{0..4}.model.1.weight``, so a reference
``lpips_alex.pth`` holding the whole model loads as it is
(``load_lpips``); so does a JAX ``.ckpt`` of converted weights, through
``convert/from_jax.py``.  Its published weights are not in the
repository: ``LPIPS(seed)`` draws random ones.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bfsr_tpu_torch.models.base import seeded
from bfsr_tpu_torch.ops import nn as fnn

# lpips.ScalingLayer's constants
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# torchvision's AlexNet features up to the last ReLU: (cin, cout, kernel,
# stride, padding) by index, "R" a ReLU, "M" a 3x3 max-pool of stride 2
_FEATURES = [(3, 64, 11, 4, 2), "R", "M", (64, 192, 5, 1, 2), "R", "M",
             (192, 384, 3, 1, 1), "R", (384, 256, 3, 1, 1), "R",
             (256, 256, 3, 1, 1), "R"]
# the published package's slices: each ends at a tapped ReLU
_SLICES = ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))
TAP_CHANNELS = (64, 192, 384, 256, 256)


def _layer(item):
    if item == "R":
        return nn.ReLU()
    if item == "M":
        return nn.MaxPool2d(3, 2)
    cin, cout, k, s, p = item
    return nn.Conv2d(cin, cout, k, s, p)


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(SCALE)[None, :, None, None])


class _AlexTaps(nn.Module):
    def __init__(self):
        super().__init__()
        for k, (lo, hi) in enumerate(_SLICES):
            block = nn.Sequential()
            for i in range(lo, hi):
                block.add_module(str(i), _layer(_FEATURES[i]))
            setattr(self, f"slice{k + 1}", block)

    def forward(self, x):
        taps = []
        for k in range(len(_SLICES)):
            x = getattr(self, f"slice{k + 1}")(x)
            taps.append(x)
        return taps


class _NetLin(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c, 1, 1,
                                                           bias=False))


class LPIPS(nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = _AlexTaps()
        for i, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{i}", _NetLin(c))
        self.reset_parameters(seeded(seed))
        self.eval().requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Random AlexNet convs (torch's default init) and every lin head
        1/C, as ``bfsr_tpu/models/lpips.py:init_lpips`` sets them."""
        for m in self.net.modules():
            if isinstance(m, nn.Conv2d):
                fnn.init_conv_(m, generator)
        for i, c in enumerate(TAP_CHANNELS):
            getattr(self, f"lin{i}").model[1].weight.fill_(1.0 / c)

    def forward(self, a, b):
        """a, b: (B, H, W, 3) in [-1, 1] -> (B,) distances."""
        sl = self.scaling_layer
        taps = [self.net((fnn.nhwc_to_nchw(x) - sl.shift) / sl.scale)
                for x in (a, b)]
        total = 0.0
        for i, (ta, tb) in enumerate(zip(*taps)):
            na = ta * torch.rsqrt((ta * ta).sum(1, keepdim=True) + 1e-10)
            nb = tb * torch.rsqrt((tb * tb).sum(1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{i}").model[1].weight
            total = total + F.conv2d((na - nb) ** 2, lin).mean((1, 2, 3))
        return total

    @torch.no_grad()
    def score(self, a, b):
        """The mean distance of NHWC arrays (numpy or tensors) in [-1, 1],
        on this module's device."""
        dev = self.scaling_layer.shift.device

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return float(self(t(a), t(b)).mean())


def load_lpips(path, device="cuda"):
    """LPIPS weights from ``path``: a torch file of the published
    package's ``state_dict`` (the scaling constants may be absent), or a
    JAX ``.ckpt`` of ``bfsr_tpu/models/lpips.py``'s params, on ``device``
    (the card unless the caller names another)."""
    from bfsr_tpu_torch.convert import from_jax
    from bfsr_tpu_torch.convert.load import read_checkpoint

    kind, payload = read_checkpoint(path)
    sd = (payload.get("state_dict", payload) if kind == "torch"
          else from_jax.lpips_state_dict(payload))
    model = LPIPS()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith("scaling_layer.")]
    if missing or unexpected:
        raise ValueError(f"{path}: not an LPIPS-alex state_dict (missing "
                         f"{missing[:4]}, unexpected {unexpected[:4]}); the "
                         "package's weight file of the lin heads alone "
                         "lacks the AlexNet convs")
    return model.to(device)
