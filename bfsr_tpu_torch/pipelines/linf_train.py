"""LINF-LP latent-module training: one train step of the prior.

The counterpart of ``bfsr_tpu/pipelines/linf_train.py:make_train_step``,
for the pixel model (``linf``, d = 3) and the patch model (``linf-patch``,
d = 3 ps^2, JAX's ``patch=True``), on one device.  A step on a batch of
crops:

1. the frozen part, under ``torch.no_grad()`` (JAX's ``stop_gradient``):
   the EDSR encoder (K3, 34 launches on the card), the Fourier head
   (cuDNN), the affine info of every sample's crop (K2, once, channel-major
   (2dL, B*H*W)) and the flow forward of the LR-up residual (K1 at d = 3,
   K4 at d = 27; once more for the HR residual, ``gt_pixel`` or
   ``gt_patch``, when ``latent_weight > 0``);
2. the trainable part, under autograd: the UNet prior with batch
   statistics (plain convs: cuDNN, as XLA convs in JAX) in the ``prior``
   stage, the flow inverse of its latent (K1's or K4's inverse with the
   plain twin's gradient, ``linf_flow.FlowInverse``) plus the bilinear LR
   (the pixel model at its queries; the patch model folds each query's
   patch and adds the LR sampled at the HR window's ``interpolate_coord``),
   clipped to [0, 1]; the L1 between its VGG19 features and the HR's (the
   VGG frozen, cuDNN), and the L1 between the latent and the HR
   residual's;
3. backward, the optimizer's step on the prior alone, one step of the LR
   schedule, and the batch statistics folded into the BatchNorms' running
   stats.

The JAX step computes the info twice, once for the encodes
(``query_log_p_grid``) and once in ``query_rgb`` (``linf_affine_info``,
by 2-D gathers).  Both are the same function of frozen weights on these
crops, which are contiguous windows of a scale's regular grid and so
separable (``bfsr_tpu/models/linf.py:query_log_p_grid``: parity 7e-7);
this step computes it once and hands it to ``query_rgb``.  The patch
model's JAX step computes its info by the 2-D gathers alone
(``query_log_p_grid`` is off for patch models); on the crop-patch
wrapper's centres it is the same function, which ``patch_grid_axes``
checks.

Precision modes (``ops/nn.py``): only ``prior`` is a stage, as in the JAX
step.  Under ``mixed`` the prior's convs take bf16 operands, forward and
backward; under ``default`` every conv and linear that reads the mode
does, the frozen encoder on the bf16 K3.  K1, K2 and K4 read no mode and
stay f32.

``kernels=False`` runs the same step with every plain twin, on any
device.  With ``kernels=True`` a CUDA batch launches the kernels or
raises, and a CPU batch runs the twins, as each kernel wrapper does.
"""

import numpy as np
import torch

from bfsr_tpu_torch.models.linf import grid_axes
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.ops.interp import grid_sample_bilinear
from bfsr_tpu_torch.pipelines.losses import l1_loss

DEFAULT_NORM = {"inp": {"sub": [0.5], "div": [0.5]},
                "gt": {"sub": [0.5], "div": [0.5]}}
BATCH_KEYS = ("inp", "coord", "cell", "gt", "gt_lr_up", "gt_pixel",
              "gt_patch", "interpolate_coord")


def to_device(batch, device, keys=BATCH_KEYS):
    """A batch's ``keys`` (numpy arrays or tensors) as float32 tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.float32, device=device)
            for k, v in batch.items() if k in keys}


def patch_grid_axes(coord, window_hw, ps):
    """(coord_y (B, Hq), coord_x (B, Wq)) of the crop-patch wrapper's
    centre grids coord (B, Hq, Wq, 2), whose HR window is ``window_hw``.

    The JAX patch step takes its info at these centres by the 2-D-gather
    ``linf_affine_info``; K2 takes per-sample axes.  The two are the same
    function where the centres form a regular grid: the wrapper pads the
    window only where ps does not divide it (``pad_amount``), and every
    ps-th coord of a contiguous window of a regular grid is a regular
    grid.  A padded window (zero coords past its edge) or a grid that is
    not separable raises."""
    B, Hq, Wq, _ = coord.shape
    if (Hq * ps, Wq * ps) != tuple(window_hw):
        raise ValueError(f"patch centres {Hq}x{Wq} do not tile the HR "
                         f"window {tuple(window_hw)} at ps={ps}: a padded "
                         "window has no regular centre grid")
    cy, cx = grid_axes(coord)
    if not (torch.equal(coord[..., 0], cy[:, :, None].expand(-1, -1, Wq))
            and torch.equal(coord[..., 1], cx[:, None, :].expand(-1, Hq, -1))):
        raise ValueError("the patch centres are not a separable grid")
    return cy, cx


def make_train_step(linf, prior, vgg, optimizer, vgg_weight=1.0,
                    latent_weight=0.0, data_norm=None, kernels=True,
                    scheduler=None, marks=None):
    """``step(batch) -> {'loss', 'vgg_l', 'latent_l'}`` (floats, one host
    fetch), which updates the prior, its optimizer and its BatchNorm
    running stats in place; ``step.loss_and_grads(batch) -> (metrics
    (tensors), grads {name: tensor}, bn_stats)`` computes the same loss
    and the prior's gradients and changes nothing.

    linf: a frozen ``LINF`` or ``LINFPatch`` (``freeze()`` called); prior:
    the ``UNet`` (``in_chans`` = ``linf.dim``);
    vgg: a frozen ``VGGFeatureExtractor`` (or None when ``vgg_weight`` is
    0); optimizer: over the prior's parameters; scheduler: a per-iteration
    LR scheduler (``train.optim.lr_scheduler``) or None; batch: the crop
    wrapper's keys (the crop-patch wrapper's for a patch model), numpy or
    tensors.  ``marks``: None, or a callable that
    takes the name of each stage as the step enters it ('frozen',
    'prior', 'decode', 'vgg', 'backward', 'update', then 'end'), for
    timing them.
    """
    if linf.imnet.w_inv is None:
        raise ValueError("freeze() the LINF model before training its prior")
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
    flow, d, ps = linf.imnet, linf.dim, linf.patch_size
    latent_key = "gt_pixel" if ps == 1 else "gt_patch"
    mark = marks or (lambda name: None)

    def encode(target, info):
        B, H, W, _ = target.shape
        return fwd(flow.w, flow.b, target.reshape(-1, d).contiguous(),
                   info).reshape(B, H, W, d)

    def frozen_part(batch):
        """The frozen part's values: {'inp' (normalized), 'feat', 'info',
        'z_lr', 'z_hr' (None without the latent loss)}."""
        with torch.no_grad():
            inp = (batch["inp"] - inp_sub) / inp_div
            coord, cell = batch["coord"], batch["cell"]
            # the patch centres' check fetches to the host: before the
            # encoder's launches are queued, it waits on the batch alone
            if ps == 1:
                cy, cx = grid_axes(coord)
            else:
                cy, cx = patch_grid_axes(
                    coord, batch["interpolate_coord"].shape[1:3], ps)
            feat = linf.gen_feat(inp, kernels=kernels)
            # one info for both encodes and the decode (see the module
            # docstring)
            info = linf.affine_info_grid(feat, cy, cx, cell, kernels=kernels)
            z_lr = encode(batch["gt_lr_up"], info)
            z_hr = (encode(batch[latent_key], info) if latent_weight > 0
                    else None)
        return {"inp": inp, "feat": feat, "info": info, "z_lr": z_lr,
                "z_hr": z_hr}

    def losses(batch, fz=None):
        mark("frozen")
        if fz is None:
            fz = frozen_part(batch)
        inp, feat, info = fz["inp"], fz["feat"], fz["info"]
        coord, cell = batch["coord"], batch["cell"]
        mark("prior")
        with fnn.stage("prior"):
            z_learned, bn_stats = prior(fz["z_lr"], inp, training=True)
        zero = torch.zeros((), device=device)
        latent_l = (l1_loss(z_learned, fz["z_hr"]) if latent_weight > 0
                    else zero)
        vgg_l = zero
        if vgg_weight > 0:
            mark("decode")
            pred = linf.query_rgb(inp, feat, coord, cell, zmap=z_learned,
                                  info=info, kernels=kernels)
            if ps != 1:
                pred = pred + grid_sample_bilinear(
                    inp, batch["interpolate_coord"], padding_mode="border")
            pred01 = torch.clamp(pred * gt_div + gt_sub, 0.0, 1.0)
            mark("vgg")
            with torch.no_grad():
                f_gt = vgg(batch["gt"])
            vgg_l = l1_loss(vgg(pred01), f_gt)
        loss = vgg_l * vgg_weight + latent_l * latent_weight
        return {"loss": loss, "vgg_l": vgg_l, "latent_l": latent_l}, bn_stats

    def loss_and_grads(batch, frozen=None):
        batch = to_device(batch, device)
        params = dict(prior.named_parameters())
        mets, bn_stats = losses(batch, frozen)
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
    step.frozen = lambda batch: frozen_part(to_device(batch, device))
    return step
