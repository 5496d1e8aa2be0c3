"""LINF-LP latent-module training: one train step of the prior.

The counterpart of ``bfsr_tpu/pipelines/linf_train.py:make_train_step``
for the pixel model, on one device.  A step on a batch of crops:

1. the frozen part, under ``torch.no_grad()`` (JAX's ``stop_gradient``):
   the EDSR encoder (K3, 34 launches on the card), the Fourier head
   (cuDNN), the affine info of every sample's crop (K2, once, channel-major
   (60, B*H*W)) and the flow forward of the LR-up residual (K1; once more
   for the HR residual when ``latent_weight > 0``);
2. the trainable part, under autograd: the UNet prior with batch
   statistics (plain convs: cuDNN, as XLA convs in JAX), the flow inverse
   of its latent (K1's inverse with the plain twin's gradient,
   ``linf_flow.FlowInverse``) plus the bilinear LR, clipped to [0, 1];
   the L1 between its VGG19 features and the HR's (the VGG frozen, cuDNN),
   and the L1 between the latent and the HR residual's;
3. backward, the optimizer's step on the prior alone, one step of the LR
   schedule, and the batch statistics folded into the BatchNorms' running
   stats.

The JAX step computes the info twice, once for the encodes
(``query_log_p_grid``) and once in ``query_rgb`` (``linf_affine_info``,
by 2-D gathers).  Both are the same function of frozen weights on these
crops, which are contiguous windows of a scale's regular grid and so
separable (``bfsr_tpu/models/linf.py:query_log_p_grid``: parity 7e-7);
this step computes it once and hands it to ``query_rgb``.

``kernels=False`` runs the same step with every plain twin, on any
device.  With ``kernels=True`` a CUDA batch launches the kernels or
raises, and a CPU batch runs the twins, as each kernel wrapper does.
"""

import numpy as np
import torch

from bfsr_tpu_torch.models.linf import grid_axes
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.pipelines.losses import l1_loss

DEFAULT_NORM = {"inp": {"sub": [0.5], "div": [0.5]},
                "gt": {"sub": [0.5], "div": [0.5]}}
BATCH_KEYS = ("inp", "coord", "cell", "gt", "gt_lr_up", "gt_pixel")


def to_device(batch, device):
    """A batch of numpy arrays (or tensors) as float32 tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.float32, device=device)
            for k, v in batch.items() if k in BATCH_KEYS}


def make_train_step(linf, prior, vgg, optimizer, vgg_weight=1.0,
                    latent_weight=0.0, data_norm=None, kernels=True,
                    scheduler=None, marks=None):
    """``step(batch) -> {'loss', 'vgg_l', 'latent_l'}`` (floats, one host
    fetch), which updates the prior, its optimizer and its BatchNorm
    running stats in place; ``step.loss_and_grads(batch) -> (metrics
    (tensors), grads {name: tensor}, bn_stats)`` computes the same loss
    and the prior's gradients and changes nothing.

    linf: a frozen ``LINF`` (``freeze()`` called); prior: the ``UNet``;
    vgg: a frozen ``VGGFeatureExtractor`` (or None when ``vgg_weight`` is
    0); optimizer: over the prior's parameters; scheduler: a per-iteration
    LR scheduler (``train.optim.lr_scheduler``) or None; batch: the crop
    wrapper's keys, numpy or tensors.  ``marks``: None, or a callable that
    takes the name of each stage as the step enters it ('frozen',
    'prior', 'decode', 'vgg', 'backward', 'update', then 'end'), for
    timing them.
    """
    if linf.imnet.w_inv is None:
        raise ValueError("freeze() the LINF model before training its prior")
    if linf.patch_size != 1:
        raise NotImplementedError("the patch trainer (--patch) is a later "
                                  "slice of the port")
    if vgg_weight > 0 and vgg is None:
        raise ValueError("vgg_weight > 0 needs the VGG feature extractor")
    dn = data_norm or DEFAULT_NORM
    device = next(prior.parameters()).device

    def norm(key, field):
        return torch.tensor(dn[key][field], dtype=torch.float32,
                            device=device)

    inp_sub, inp_div = norm("inp", "sub"), norm("inp", "div")
    gt_sub, gt_div = norm("gt", "sub"), norm("gt", "div")
    fwd = linf_flow.flow_forward if kernels else linf_flow.flow_forward_plain
    flow, d = linf.imnet, linf.dim
    mark = marks or (lambda name: None)

    def encode(target, info):
        B, H, W, _ = target.shape
        return fwd(flow.w, flow.b, target.reshape(-1, d).contiguous(),
                   info).reshape(B, H, W, d)

    def losses(batch):
        mark("frozen")
        with torch.no_grad():
            inp = (batch["inp"] - inp_sub) / inp_div
            coord, cell = batch["coord"], batch["cell"]
            feat = linf.gen_feat(inp, kernels=kernels)
            cy, cx = grid_axes(coord)
            # one info for both encodes and the decode (see the module
            # docstring)
            info = linf.affine_info_grid(feat, cy, cx, cell, kernels=kernels)
            z_lr = encode(batch["gt_lr_up"], info)
            z_hr = (encode(batch["gt_pixel"], info) if latent_weight > 0
                    else None)
        mark("prior")
        with fnn.stage("prior"):
            z_learned, bn_stats = prior(z_lr, inp, training=True)
        zero = torch.zeros((), device=device)
        latent_l = l1_loss(z_learned, z_hr) if latent_weight > 0 else zero
        vgg_l = zero
        if vgg_weight > 0:
            mark("decode")
            pred = linf.query_rgb(inp, feat, coord, cell, zmap=z_learned,
                                  info=info, kernels=kernels)
            pred01 = torch.clamp(pred * gt_div + gt_sub, 0.0, 1.0)
            mark("vgg")
            with torch.no_grad():
                f_gt = vgg(batch["gt"])
            vgg_l = l1_loss(vgg(pred01), f_gt)
        loss = vgg_l * vgg_weight + latent_l * latent_weight
        return {"loss": loss, "vgg_l": vgg_l, "latent_l": latent_l}, bn_stats

    def loss_and_grads(batch):
        batch = to_device(batch, device)
        params = dict(prior.named_parameters())
        mets, bn_stats = losses(batch)
        grads = torch.autograd.grad(mets["loss"], list(params.values()))
        return ({k: v.detach() for k, v in mets.items()},
                dict(zip(params, grads)), bn_stats)

    def step(batch):
        batch = to_device(batch, device)
        mets, bn_stats = losses(batch)
        mark("backward")
        optimizer.zero_grad(set_to_none=True)
        mets["loss"].backward()
        mark("update")
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        prior.apply_bn_updates(bn_stats)
        mark("end")
        values = torch.stack([mets[k].detach() for k in mets]).tolist()
        return dict(zip(mets, values))

    step.loss_and_grads = loss_and_grads
    return step
