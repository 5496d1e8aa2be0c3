"""LINF(-LP) whole-image inference and the PSNR/SSIM eval loop, on one
device.

The counterpart of ``bfsr_tpu/pipelines/linf_eval.py``: ``LINFPredictor``
on its fused-kernel path (``_predict_pallas``) and ``eval_psnr``.  For a
regular query grid (the HR grid of a pixel model, the patch-centre grid
of a patch model) and d = 3 ps^2:

1. the EDSR encoder (K3 on CUDA);
2. the coef/freq 3x3 convs;
3. the per-query affine info, computed ONCE and shared by the forward and
   inverse flow passes (K2 on CUDA), channel-major (2dL, H*W);
4. with a prior: the flow forward of the ``gt_lr_up`` residual (K1 at
   d = 3, K4 at d = 27),
5. the UNet prior (K3 at full resolution),
6. the flow inverse (K1 / K4) of the learned latent; without a prior, the
   inverse of zeros (temperature 0) or of N(0, t^2) noise drawn from the
   caller's ``torch.Generator``;
7. the pixel model's bilinear LR add-back, or the patch model's fold.

Steps 6-7 are the model's own ``LINF.query_rgb``, given the shared info.

``kernels=True`` runs each step's kernel wrapper (the CUDA kernel for a
CUDA tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the
plain twins on any device, the reference the kernel path is held to.
Batch 1; no H/W padding is needed (the kernels take any extent).

``predict`` scopes its steps as the JAX predictor does, for the
precision modes (``ops/nn.py``): ``encoder`` (1), ``head`` (2-3),
``prior`` (5) and ``addback`` (6-7; the flows read no mode).  Both paths
follow the mode alike: under ``mixed`` the prior's convs take bf16
operands, under ``default`` every conv and linear does; K1 and K2 stay
f32 in every mode.
"""

from functools import partial

import numpy as np
import torch

from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
from bfsr_tpu_torch.models.linf import grid_axes
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.ops.imresize import imresize
from bfsr_tpu_torch.utils import metrics as M
from bfsr_tpu_torch.utils.misc import Averager


def device_psnr(pred01, gt01, dataset=None, scale=1):
    """PSNR in float32 on the tensors' device (``utils.metrics.calc_psnr``
    semantics: 'benchmark' takes the Y channel and, with 'div2k', shaves
    ``scale`` border pixels)."""
    diff = pred01 - gt01
    if dataset == "benchmark":
        coeffs = torch.tensor([65.738, 129.057, 25.064], dtype=torch.float32,
                              device=diff.device) / 256.0
        diff = (diff * coeffs).sum(-1, keepdim=True)
    if dataset in ("benchmark", "div2k"):
        diff = diff[:, scale:-scale, scale:-scale]
    mse = torch.mean(diff.float() ** 2)
    return -10.0 * torch.log10(mse)


class LINFPredictor:
    """Whole-image predictor for a frozen LINF model + optional prior."""

    def __init__(self, model, prior_model=None, kernels=True):
        if model.imnet.w_inv is None:
            raise ValueError("freeze() the LINF model before predicting")
        self.model = model
        self.prior = prior_model
        self.kernels = kernels

    @torch.inference_mode()
    def predict(self, inp, coord, cell, gt_lr_up=None, temperature=0.0,
                generator=None):
        """inp: (1, h, w, 3) normalized LR; coord: (1, H, W, 2) regular
        grid; cell: (1, 2); gt_lr_up: (1, H, W, d) residual (prior path).
        Without a prior (or residual), ``temperature`` > 0 samples z from
        ``generator`` (a ``torch.Generator`` on ``inp``'s device).
        Returns the prediction (1, H, W, 3), or for a patch model the
        folded residual (1, H ps, W ps, 3), whose LR add-back is the
        caller's."""
        if inp.shape[0] != 1:
            raise ValueError("LINFPredictor runs batch 1")
        model, kernels = self.model, self.kernels
        _, H, W, _ = coord.shape
        cy, cx = grid_axes(coord)

        with fnn.stage("encoder"):
            feat = model.gen_feat(inp, kernels=kernels)
        with fnn.stage("head"):
            info = model.affine_info_grid(feat, cy, cx, cell, kernels=kernels)

        zmap = None
        if self.prior is not None and gt_lr_up is not None:
            fwd = (linf_flow.flow_forward if kernels
                   else linf_flow.flow_forward_plain)
            d = model.dim
            z = fwd(model.imnet.w, model.imnet.b,
                    gt_lr_up.reshape(H * W, d).contiguous(), info)
            with fnn.stage("prior"):
                zmap = self.prior(z.reshape(1, H, W, d), inp, kernels=kernels)
        with fnn.stage("addback"):
            return model.query_rgb(inp, feat, coord, cell, temperature, zmap,
                                   generator, info=info, kernels=kernels)


def _psnr_fn(eval_type, scale_max):
    """(host PSNR function, scale, device_psnr dataset) of an eval_type:
    None, 'div2k-<s>' or 'benchmark-<s>'."""
    if eval_type is None:
        return M.calc_psnr, scale_max, None
    for dataset in ("div2k", "benchmark"):
        if eval_type.startswith(dataset):
            scale = int(eval_type.split("-")[1])
            return (partial(M.calc_psnr, dataset=dataset, scale=scale),
                    scale, dataset)
    raise NotImplementedError(eval_type)


def eval_psnr(loader, model, prior_model=None, data_norm=None,
              eval_type=None, scale_max=4, detail=False, patch=False,
              kernels=True):
    """``bfsr_tpu.pipelines.linf_eval.eval_psnr`` on ``LINFPredictor``.

    ``loader``: any iterable of batches of one (numpy dicts with ``inp``,
    ``coord``, ``cell``, ``gt`` and, for the prior path, ``gt_lr_up``, as
    ``data.wrappers.batches`` gives them).  The model runs on its own
    device.  Without ``detail`` a pixel model's PSNR is computed on the
    device (``device_psnr``); otherwise the image comes to the host, where
    the metrics run in float64.  A patch model's prediction is the folded
    residual: the bilinear LR add-back is done on the host.  ``detail``
    returns {'psnr', 'ssim', 'lpips' (nan: LPIPS is not ported),
    'LR recon'}; else the mean PSNR.  Without a prior (or residual) the
    flow decodes z = 0, temperature 0.
    """
    if data_norm is None:
        data_norm = {"inp": {"sub": [0], "div": [1]},
                     "gt": {"sub": [0], "div": [1]}}
    inp_sub, inp_div, gt_sub, gt_div = (
        np.array(data_norm[k][f], np.float32)
        for k, f in (("inp", "sub"), ("inp", "div"), ("gt", "sub"),
                     ("gt", "div")))
    psnr_fn, scale, dataset = _psnr_fn(eval_type, scale_max)
    dev = next(model.parameters()).device
    predictor = LINFPredictor(model, prior_model, kernels=kernels)
    val_psnr, val_ssim, val_lr = Averager(), Averager(), Averager()

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    for batch in loader:
        inp = (batch["inp"] - inp_sub) / inp_div
        gt = batch["gt"]
        pred = predictor.predict(
            t(inp), t(batch["coord"]), t(batch["cell"]),
            t(batch["gt_lr_up"]) if "gt_lr_up" in batch else None,
        )[:, :gt.shape[1], :gt.shape[2]]
        if not detail and not patch:
            pred01 = torch.clamp(pred * t(gt_div) + t(gt_sub), 0, 1)
            val_psnr.add(float(device_psnr(pred01, t(gt), dataset, scale)))
        else:
            pred = pred.cpu().numpy()
            if patch:
                pred = pred + resize_bilinear_np(inp[0], pred.shape[1:3])[None]
            pred01 = np.clip(pred * gt_div + gt_sub, 0, 1)
            val_psnr.add(psnr_fn(np.transpose(pred01, (0, 3, 1, 2)),
                                 np.transpose(gt, (0, 3, 1, 2))))
            if detail:
                val_ssim.add(M.calculate_ssim(pred01[0] * 255.0,
                                              gt[0] * 255.0))
                lr_recon = imresize(pred01[0].astype(np.float64),
                                    scale=1.0 / scale)
                val_lr.add(psnr_fn(
                    np.transpose(lr_recon[None], (0, 3, 1, 2)),
                    np.transpose(batch["inp"], (0, 3, 1, 2))))

    if detail:
        return {"psnr": val_psnr.item(), "ssim": val_ssim.item(),
                "lpips": float("nan"), "LR recon": val_lr.item()}
    return val_psnr.item()
