"""Loss functions: the counterpart of ``bfsr_tpu/pipelines/losses.py``
(the reference's ``SRFlow-LP/code/models/modules/loss.py``): the pixel
criteria of the plain-SR trainer, the NLL in bits/dim of the flow, and
the GAN path's ``gan_loss`` and ``gradient_penalty_loss``, which no
shipped config trains with."""

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


def gan_loss(gan_type, logits, target_is_real, real_label_val=1.0,
             fake_label_val=0.0):
    """GANLoss: 'gan' / 'ragan' are BCE-with-logits against the constant
    label, 'lsgan' the MSE to it, 'wgan-gp' -mean(logits) for a real
    target and mean(logits) for a fake one."""
    gan_type = gan_type.lower()
    if gan_type == "wgan-gp":
        m = torch.mean(logits)
        return -m if target_is_real else m
    label = real_label_val if target_is_real else fake_label_val
    if gan_type in ("gan", "ragan"):
        x = logits
        return torch.mean(torch.clamp(x, min=0.0) - x * label
                          + torch.log1p(torch.exp(-torch.abs(x))))
    if gan_type == "lsgan":
        return torch.mean((logits - label) ** 2)
    raise NotImplementedError(f"GAN type [{gan_type}] is not found")


def gradient_penalty_loss(critic_fn, interp):
    """GradientPenaltyLoss: mean over the batch of (||d critic / d interp||_2
    - 1)^2, the gradient of the summed critic scores taken with a graph,
    so that the penalty itself is differentiable."""
    x = interp if interp.requires_grad else \
        interp.detach().requires_grad_(True)
    grads = torch.autograd.grad(critic_fn(x).sum(), x, create_graph=True)[0]
    norms = grads.reshape(grads.shape[0], -1).norm(dim=1)
    return torch.mean((norms - 1.0) ** 2)
