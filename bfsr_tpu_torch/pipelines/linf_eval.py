"""LINF(-LP) whole-image inference and the PSNR/SSIM eval loop, on one
device.

The counterpart of ``bfsr_tpu/pipelines/linf_eval.py``: ``LINFPredictor``
on its fused-kernel path (``_predict_pallas``) and ``eval_psnr``.  For a
regular query grid (the HR grid of a pixel model, the patch-centre grid
of a patch model) and d = 3 ps^2:

1. the encoder (EDSR-baseline and RRDB on K3 on CUDA; the others on
   plain convs);
2. the coef/freq 3x3 convs;
3. the per-query affine info, computed ONCE and shared by the forward and
   inverse flow passes (K2 on CUDA), channel-major (2dL, H*W);
4. with a prior: the flow forward of the ``gt_lr_up`` residual (K1 at
   d = 3, K4 at d = 27),
5. the latent module (the UNet's full-resolution stages and
   ``edsr-baseline-latent``'s convs on K3; ``swin_latent`` plain),
6. the flow inverse (K1 / K4) of the learned latent; without a prior, the
   inverse of zeros (temperature 0) or of N(0, t^2) noise drawn from the
   caller's ``torch.Generator``;
7. the pixel model's bilinear LR add-back, or the patch model's fold.

Steps 6-7 are the model's own ``LINF.query_rgb``, given the shared info.

``kernels=True`` runs each step's kernel wrapper (the CUDA kernel for a
CUDA tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the
plain twins on any device, the reference the kernel path is held to.
No H/W padding is needed (the kernels take any extent).

The same chain runs at any query set (B, h, w, 2), for batches whose
coords are not a grid or that hold more than one sample (the trainer's
validation); only step 3 differs: each query's info comes from the
2-D-gather ``LINF.linf_affine_info`` (plain torch, as ``bfsr_tpu/models/
linf.py:61`` computes it outside any kernel, so K2 does not run), and
step 7 adds the bilinear LR back at each query's own coordinate.  This
holds the reference's semantics: the JAX predictor reads a batch's grid
axes off row 0 and column 0 (``bfsr_tpu/pipelines/linf_eval.py:
106-107``), so at coords that are not a grid the JAX ``eval_psnr``
predicts queries other than those of its ``gt``.

``predict_sharded`` is the query-sharded (sp) predict of one image, and
``predict_dp`` / ``dp_psnr`` the dp-sharded eval of a batch (see
``parallel/mesh.py``).

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
import torch.nn.functional as F

from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
from bfsr_tpu_torch.models.linf import grid_axes
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import linf_flow
from bfsr_tpu_torch.ops.imresize import imresize
from bfsr_tpu_torch.utils import metrics as M
from bfsr_tpu_torch.utils.coords import make_cell, make_coord
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
                generator=None, z=None):
        """inp: (B, h, w, 3) normalized LR; coord: (B, H, W, 2) queries;
        cell: (B, 2); gt_lr_up: (B, H, W, d) residual (prior path).
        Without a prior (or residual) the flow decodes ``z`` (B, H, W, d)
        if given, else zeros, or at ``temperature`` > 0 N(0, t^2) samples
        from ``generator`` (a ``torch.Generator`` on ``inp``'s device).

        One sample on a regular grid, and a patch model's patch-centre
        grid (one sample; its padded zero coords are read by the grid's
        axes, as the JAX predictor reads them), take their info from the
        grid's axes (K2); any other query set, or more than one sample,
        from each query's own coordinate (``LINF.linf_affine_info``).
        Returns the prediction (B, H, W, 3), or for a patch model the
        folded residual (1, H ps, W ps, 3), whose LR add-back is the
        caller's."""
        model, kernels = self.model, self.kernels
        B, H, W, _ = coord.shape
        patch = model.patch_size != 1
        if patch and B != 1:
            raise ValueError("a patch model predicts its patch-centre grid, "
                             "batch 1")
        on_grid = patch or (B == 1 and is_grid(coord))

        with fnn.stage("encoder"):
            feat = model.gen_feat(inp, kernels=kernels)
        with fnn.stage("head"):
            if on_grid:
                cy, cx = grid_axes(coord)
                info = model.affine_info_grid(feat, cy, cx, cell,
                                              kernels=kernels)
            else:
                info = model.linf_affine_info(feat, coord, cell)
                info = info.reshape(B * H * W, -1).T.contiguous()

        zmap = z
        if self.prior is not None and gt_lr_up is not None:
            fwd = (linf_flow.flow_forward if kernels
                   else linf_flow.flow_forward_plain)
            d = model.dim
            z = fwd(model.imnet.w, model.imnet.b,
                    gt_lr_up.reshape(B * H * W, d).contiguous(), info)
            with fnn.stage("prior"):
                zmap = self.prior(z.reshape(B, H, W, d), inp, kernels=kernels)
        with fnn.stage("addback"):
            return model.query_rgb(inp, feat, coord, cell, temperature, zmap,
                                   generator, info=info, kernels=kernels,
                                   grid=on_grid)


    @torch.inference_mode()
    def predict_sharded(self, mesh, inp, coord, cell, gt_lr_up=None,
                        axis="sp"):
        """The query-sharded predict of one image (``tests/
        test_sharded.py``'s sp predict): ``coord`` (1, H / sp, W, 2) and
        ``gt_lr_up`` this rank's rows of the HR grid, in the rank order of
        ``mesh``'s ``axis``; ``inp`` and ``cell`` whole.  The encoder runs
        on every rank; K2 and the flow forward (K1) on the rank's rows;
        with a prior, z is gathered over ``axis`` (a plain ``all_gather``)
        and the latent module runs on the whole grid, as the single
        predict's does, and the flow inverse and the add-back on the
        rank's rows.  Returns the rank's rows of the prediction (1, H /
        sp, W, 3), those of ``predict`` on the whole grid."""
        from bfsr_tpu_torch.parallel.collective import gather_rows

        model, kernels = self.model, self.kernels
        B, Hl, W, _ = coord.shape
        if B != 1 or model.patch_size != 1 or not is_grid(coord):
            raise ValueError("the query-sharded predict takes one pixel "
                             "model's image, its rows of a regular grid")
        with fnn.stage("encoder"):
            feat = model.gen_feat(inp, kernels=kernels)
        with fnn.stage("head"):
            cy, cx = grid_axes(coord)
            info = model.affine_info_grid(feat, cy, cx, cell,
                                          kernels=kernels)
        zmap = None
        if self.prior is not None and gt_lr_up is not None:
            fwd = (linf_flow.flow_forward if kernels
                   else linf_flow.flow_forward_plain)
            d = model.dim
            z = fwd(model.imnet.w, model.imnet.b,
                    gt_lr_up.reshape(Hl * W, d).contiguous(), info)
            z = gather_rows(z.reshape(1, Hl, W, d), mesh.group(axis))
            with fnn.stage("prior"):
                zmap = self.prior(z, inp, kernels=kernels)
            i = mesh.index(axis)
            zmap = zmap[:, i * Hl:(i + 1) * Hl].contiguous()
        with fnn.stage("addback"):
            return model.query_rgb(inp, feat, coord, cell, 0.0, zmap,
                                   info=info, kernels=kernels)


def predict_dp(predictor, inp, coord, cell, gt_lr_up=None):
    """This rank's images of a dp-sharded batch (``tests/test_sharded.py``'s
    dp predict, ``bench.py --multichip``): each of its B / dp images
    through ``predictor.predict`` at batch 1 (its grid's info on K2), the
    result (B / dp, H, W, 3) kept on the rank."""
    return torch.cat([predictor.predict(
        inp[i:i + 1], coord[i:i + 1], cell[i:i + 1],
        None if gt_lr_up is None else gt_lr_up[i:i + 1])
        for i in range(inp.shape[0])])


def dp_psnr(mesh, pred01, gt01, axis="dp"):
    """The PSNR of a dp-sharded eval's images (this rank's ``pred01`` and
    ``gt01``, (n, H, W, 3) in [0, 1]) over all ranks' pixels: each rank's
    squared-error and pixel-count sums, one all-reduce
    (``parallel.collective.distributed_psnr``)."""
    from bfsr_tpu_torch.parallel.collective import distributed_psnr

    se = ((pred01 - gt01).float() ** 2).reshape(pred01.shape[0], -1)
    n = torch.full((pred01.shape[0],), float(se.shape[1]),
                   device=pred01.device)
    return distributed_psnr(mesh, se.sum(1), n, axis)


def is_grid(coord):
    """Whether every sample of coord (B, H, W, 2) is the grid of its row 0
    and column 0: its rows' y and its columns' x constant."""
    cy, cx = grid_axes(coord)
    return bool((coord[..., 0] == cy[:, :, None]).all()
                and (coord[..., 1] == cx[:, None, :]).all())


def draw_latent(shape, seed, device):
    """N(0, 1) latents of ``shape`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed``: the temperature samples of
    ``eval_psnr``, image by image and sample by sample."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


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


def _bucket(h, w, pad_multiple):
    """An LR shape's bucket: (h, w), or with ``pad_multiple`` the next
    multiple past each (a multiple itself gains one more), as
    ``eval_psnr``'s window pad takes it."""
    if not pad_multiple:
        return h, w
    return ((h // pad_multiple + 1) * pad_multiple,
            (w // pad_multiple + 1) * pad_multiple)


def warmup_predictor(model, prior_model, lr_shapes, scale, pad_multiple=0,
                     log_fn=print):
    """One predict of zeros per LR-shape bucket, before a sweep: on the
    card it builds the kernels and primes cuDNN's algorithm choice for each
    shape.  lr_shapes: (h, w) LR sizes; shapes that fall in one bucket
    (``pad_multiple``) run once.  A patch model predicts its padded centre
    grid at 3 ps^2 channels, as the patch wrappers lay it out.  Returns the
    buckets."""
    import time

    buckets = list(dict.fromkeys(_bucket(h, w, pad_multiple)
                                 for h, w in lr_shapes))
    predictor = LINFPredictor(model, prior_model)
    dev = next(model.parameters()).device
    ps = model.patch_size
    for h, w in buckets:
        t0 = time.perf_counter()
        H, W = scale * h, scale * w
        grid = ((H + ps - H % ps) // ps, (W + ps - W % ps) // ps) \
            if ps > 1 else (H, W)
        coord = torch.as_tensor(make_coord(grid, flatten=False)[None],
                                device=dev)
        gt_lr_up = (torch.zeros((1, *grid, model.dim), device=dev)
                    if prior_model is not None else None)
        predictor.predict(torch.zeros((1, h, w, 3), device=dev), coord,
                          torch.as_tensor(make_cell((H, W))[None],
                                          device=dev), gt_lr_up)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log_fn(f"warmup: LR {h}x{w} (scale {scale}) in "
               f"{time.perf_counter() - t0:.1f}s")
    return buckets


def _window_pad(inp, window, scale):
    """The SwinIR window protocol: the LR reflect-padded (with a flipped
    copy) past the next multiple of ``window``, and the padded HR grid's
    coords, one per sample."""
    B, h, w = inp.shape[:3]
    hp, wp = _bucket(h, w, window)
    inp = np.concatenate([inp, inp[:, ::-1]], axis=1)[:, :hp]
    inp = np.concatenate([inp, inp[:, :, ::-1]], axis=2)[:, :, :wp]
    coord = make_coord((scale * hp, scale * wp), flatten=False)
    return inp, np.broadcast_to(coord, (B, *coord.shape)).copy()


def eval_psnr(loader, model, prior_model=None, data_norm=None,
              eval_type=None, eval_bsize=None, window_size=0, scale_max=4,
              verbose=False, detail=False, randomness=False, temperature=0.0,
              patch=False, tile_queries=65536, lpips_model=None,
              log_fn=print, limit=None, sample=0, save_path=None,
              pad_multiple=0, kernels=True):
    """``bfsr_tpu.pipelines.linf_eval.eval_psnr``, its whole surface.

    ``loader``: any iterable of batches (numpy dicts with ``inp``,
    ``coord``, ``cell``, ``gt`` and, for the prior path, ``gt_lr_up``, as
    ``data.wrappers.batches`` or ``data.loader.DataLoader`` give them).
    The model runs on its own device, through ``LINFPredictor.predict``:
    a batch of more than one sample, or whose coords are not a grid
    (``sr-implicit-downsampled-fast`` with ``inp_size``), is predicted at
    each query's own coordinate.  A patch model runs one image a batch on
    its patch-centre grid.  Each batch adds its PSNR once (over all its
    samples), as the JAX version averages.

    ``window_size`` or ``pad_multiple``: reflect-pad the LR past the next
    multiple, query the padded HR grid (a zero-padded ``gt_lr_up``) and
    crop back; not with ``patch``.  Without a prior (or residual) the flow
    decodes zeros, or, at ``temperature`` > 0, N(0, t^2) latents from
    ``draw_latent`` seeded idx 131 + s for image idx, sample s.
    ``randomness``: 5 samples, their mean metrics and, with ``detail``,
    the diversity (the std over samples, ddof 1, of the uint8-rounded
    images).  ``sample`` / ``save_path``: the first ``sample`` images
    saved as ``{800 + idx + 1}x{scale}.png``.  ``limit``: the first
    ``limit`` batches.  ``lpips_model`` (``models.lpips.LPIPS``) adds
    LPIPS under ``detail``.  ``eval_bsize`` and ``tile_queries`` are
    accepted and change nothing: the JAX version tiles the query grid to
    bound its memory, the port computes each image whole.

    A PSNR alone, for a pixel model, is computed on the device
    (``device_psnr``); otherwise the images come to the host, where the
    metrics run in float64.  A patch model's prediction is the folded
    residual: the bilinear LR add-back is done on the host.  Returns the
    mean PSNR, or with ``detail`` {'psnr', 'ssim', 'lpips' (nan without
    ``lpips_model``), 'LR recon'} and, with ``randomness``,
    'diversity'.
    """
    if data_norm is None:
        data_norm = {"inp": {"sub": [0], "div": [1]},
                     "gt": {"sub": [0], "div": [1]}}
    inp_sub, inp_div, gt_sub, gt_div = (
        np.array(data_norm[k][f], np.float32)
        for k, f in (("inp", "sub"), ("inp", "div"), ("gt", "sub"),
                     ("gt", "div")))
    window = window_size or pad_multiple
    if window and patch:
        raise ValueError("window/pad_multiple cannot be combined with patch "
                         "mode: patch eval queries patch-centre grids, not "
                         "the padded full grid")
    psnr_fn, scale, dataset = _psnr_fn(eval_type, scale_max)
    dev = next(model.parameters()).device
    predictor = LINFPredictor(model, prior_model, kernels=kernels)
    val_psnr, val_ssim, val_lpips, val_lr, val_div = (
        Averager() for _ in range(5))
    n_samples = 5 if randomness else 1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    def mean(values):  # the JAX version's sum / len, bit for bit
        values = list(values)
        return sum(values) / len(values)

    for idx, batch in enumerate(loader):
        if limit is not None and idx >= limit:
            break
        inp = (batch["inp"] - inp_sub) / inp_div
        gt = batch["gt"]
        coord = batch["coord"]
        if window:
            inp, coord = _window_pad(inp, window, scale)
        inp_t, coord_t, cell_t = t(inp), t(coord), t(batch["cell"])
        gt_lr_up = t(batch["gt_lr_up"]) if "gt_lr_up" in batch else None
        if gt_lr_up is not None and gt_lr_up.shape[1:3] != coord_t.shape[1:3]:
            dh = coord_t.shape[1] - gt_lr_up.shape[1]
            dw = coord_t.shape[2] - gt_lr_up.shape[2]
            gt_lr_up = F.pad(gt_lr_up, (0, 0, 0, dw, 0, dh))
        use_prior = prior_model is not None and gt_lr_up is not None

        def predict(s):
            z = None
            if not use_prior and temperature:
                z = draw_latent((*coord_t.shape[:3], model.dim),
                                idx * 131 + s, dev) * temperature
            out = predictor.predict(inp_t, coord_t, cell_t, gt_lr_up, z=z)
            return out[:, :gt.shape[1], :gt.shape[2]]

        saving = idx < sample and save_path
        if not (detail or randomness or saving or patch):
            pred01 = torch.clamp(predict(0) * t(gt_div) + t(gt_sub), 0, 1)
            val_psnr.add(float(device_psnr(pred01, t(gt), dataset, scale)))
            if verbose:
                log_fn(f"[{idx}] psnr {val_psnr.item():.4f}")
            continue

        preds = []
        for s in range(n_samples):
            pred = predict(s).cpu().numpy()
            if patch:
                pred = pred + resize_bilinear_np(inp[0], pred.shape[1:3])[None]
            preds.append(pred)
        denorm = [np.clip(p * gt_div + gt_sub, 0, 1) for p in preds]
        if saving:
            import os

            from PIL import Image

            os.makedirs(save_path, exist_ok=True)
            Image.fromarray(np.round(denorm[0][0] * 255.0).astype(np.uint8)
                            ).save(os.path.join(save_path,
                                                f"{800 + idx + 1}x{scale}.png"))
        gt_nchw = np.transpose(gt, (0, 3, 1, 2))
        val_psnr.add(mean(psnr_fn(np.transpose(p, (0, 3, 1, 2)), gt_nchw)
                          for p in denorm))
        if detail:
            val_ssim.add(mean(M.calculate_ssim(p[0] * 255.0, gt[0] * 255.0)
                              for p in denorm))
            if lpips_model is not None:
                val_lpips.add(mean(
                    lpips_model.score(np.clip(p, -1, 1),
                                      (gt - gt_sub) / gt_div)
                    for p in preds))
            inp_nchw = np.transpose(batch["inp"], (0, 3, 1, 2))
            val_lr.add(mean(
                psnr_fn(np.transpose(imresize(p[0].astype(np.float64),
                                              scale=1.0 / scale)[None],
                                     (0, 3, 1, 2)), inp_nchw)
                for p in denorm))
        if randomness:
            stack = np.stack([np.round(p[0] * 255.0) for p in denorm])
            val_div.add(float(np.std(stack, axis=0, ddof=1).mean()))
        if verbose:
            log_fn(f"[{idx}] psnr {val_psnr.item():.4f}")

    if detail:
        out = {"psnr": val_psnr.item(), "ssim": val_ssim.item(),
               "lpips": (val_lpips.item() if lpips_model is not None
                         else float("nan")),
               "LR recon": val_lr.item()}
        if randomness:
            out["diversity"] = val_div.item()
        return out
    return val_psnr.item()
