"""Plain (non-flow) SR training: the RRDB x4 generator with a pixel
criterion, and the x8 self-ensemble.

The counterpart of ``bfsr_tpu/pipelines/sr_train.py`` (the reference's
``SR_model.py``), on one device.  The generator trains on
``kernels=False`` (its dense-block convs through ``fnn.conv2d``: cuDNN on
the card; K3 has no backward).  The criteria are the torch modules the
reference wires up: 'l1' ``nn.L1Loss`` (mean), 'l2' ``nn.MSELoss``
(mean), 'cb' ``CharbonnierLoss``, a SUM over the elements, not a mean:
its gradients scale with the element count, and the reference's configs
tune their learning rates against that.
"""

import torch

from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.pipelines.losses import (charbonnier_loss, l1_loss,
                                             l2_loss)

CRITERIA = {"l1": l1_loss, "l2": l2_loss, "cb": charbonnier_loss}


def make_sr_train_step(model, optimizer, pixel_criterion="cb",
                       pixel_weight=1.0, scheduler=None):
    """``step(batch) -> {'loss': float}``, which updates ``model`` (an
    ``'rrdb'`` model with its head) and ``optimizer`` in place;
    ``step.loss_and_grads(batch) -> (loss, grads {name: tensor})`` changes
    nothing.  batch: {'LQ': (B, h, w, 3), 'GT': (B, 4h, 4w, 3)}."""
    if pixel_criterion not in CRITERIA:
        raise NotImplementedError(
            f"Loss type [{pixel_criterion}] is not recognized.")
    crit = CRITERIA[pixel_criterion]
    device = next(model.parameters()).device

    def loss_fn(batch):
        return pixel_weight * crit(model(batch["LQ"], kernels=False),
                                   batch["GT"])

    def loss_and_grads(batch):
        batch = to_device(batch, device, ("LQ", "GT"))
        params = dict(model.named_parameters())
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def step(batch):
        batch = to_device(batch, device, ("LQ", "GT"))
        loss = loss_fn(batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": float(loss.detach())}

    step.loss_and_grads = loss_and_grads
    return step


@torch.no_grad()
def test_x8(model, lq, kernels=True):
    """Geometric self-ensemble (``SR_model.py test_x8``): the model's mean
    over the 8 flip / transpose symmetries of lq (B, h, w, 3)."""
    def tf(x, op):
        if op == "v":
            return x.flip(2)
        if op == "h":
            return x.flip(1)
        return x.transpose(1, 2)

    outs = []
    for ops in ([], ["v"], ["h"], ["t"], ["v", "h"], ["v", "t"], ["h", "t"],
                ["v", "h", "t"]):
        x = lq
        for op in ops:
            x = tf(x, op)
        y = model(x.contiguous(), kernels=kernels)
        for op in reversed(ops):
            y = tf(y, op)
        outs.append(y)
    return sum(outs) / len(outs)
