"""Loss functions: the counterpart of ``bfsr_tpu/pipelines/losses.py``'s
``l1_loss``, ``l2_loss``, ``charbonnier_loss`` and ``nll_bits_per_dim``
(the reference's ``SRFlow-LP/code/models/modules/loss.py``).  The GAN
losses wait for the SRFlow trainers."""

import math

import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def charbonnier_loss(pred, target, eps=1e-6):
    """sum(sqrt(diff^2 + eps)): a SUM over all elements, eps added
    unsquared, as the reference's CharbonnierLoss."""
    diff = pred - target
    return torch.sum(torch.sqrt(diff * diff + eps))


def nll_bits_per_dim(objective, pixels):
    """-(logdet + base logp) / (log 2 * pixels)."""
    return -objective / (math.log(2.0) * pixels)
