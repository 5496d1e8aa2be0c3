"""The flagship LINF-LP, LINF-LP patch and SRFlow-LP models on a device,
from a seed.  Each ``build_*`` function (and ``entry``) runs on
``"cuda"`` unless the caller passes another device.

The counterpart of ``__graft_entry__._flagship`` / ``entry``: an
EDSR-baseline encoder (16 blocks, 64 ch), a 10-layer pointwise flow, a
256-wide info MLP (1024 -> 256 -> 256 -> 256 -> 60) and a UNet prior
(depth 3, dim 64); ``tiny=True`` gives the CPU test size (EDSR 2 x 16,
flow L=3, hidden 32, UNet depth 2 / dim 16), which runs on the CPU only:
K2 takes hidden 128 or 256, so on a CUDA device its predict raises.
Weights are random, drawn from
``torch.Generator().manual_seed(seed)``; the flow weights get ``+ I``, as
trained checkpoints are well conditioned and random ones make the inverse
chain explode.

``build_flagship_trainer`` is the LINF-LP trainer of
``configs/train/train_edsr-baseline-linf-LP.yaml`` on the same models:
the frozen LINF, the UNet prior to train, and a frozen VGG19 through
conv5_4 (``feature_layer`` 34; 8 with ``tiny=True``, which runs on the CPU
only).  No VGG weights ship with the repository: the VGG's convs are drawn
He-normal (fan-in, ReLU gain) with zero biases, so that its features keep
their scale through 16 convs as trained ones do; torch's default init
(``VGGFeatureExtractor.reset_parameters``) shrinks them by ~1e6 and leaves
the perceptual loss's gradients under Adam's eps.  ``example_train_batch``
makes a synthetic batch in the crop wrapper's layout.

``build_linf_patch`` is the patch model of ``bench.py``'s patch workload:
``linf-patch`` with ps = 3 (d = 27), the same encoder, flow L = 10, info
MLP 1024 -> 256 -> 256 -> 256 -> 540, and a UNet prior with in_chans 27,
depth 3, dim 64; the flow weights are ``w * 0.05 + I``, as in
``bench.py``.  ``tiny=True`` gives ``tests/test_pallas_predictor.py``'s
patch size (EDSR 2 x 16, L = 3, hidden 32, UNet depth 2 / dim 16) and runs
on the CPU only.  ``build_patch_trainer`` is its trainer (``train.py
--patch 3``): the frozen patch model, its prior in train mode and the
VGG19 as ``build_flagship_trainer`` draws it; ``example_patch_train_batch``
a synthetic batch in the ``sr-implicit-downsampled-fast-crop-patch``
layout (LR crops of 3 x ``inp_size``).

``build_rrdb_linf`` is path (A) of the other encoders' slice,
``configs/train/train_rrdb-linf-LP.yaml``: the flagship's flow, info MLP
and UNet prior on an RRDB encoder (nf 64, nb 23, gc 32); ``build_swin_prior``
is path (B), the flagship LINF with the ``swin_latent`` prior (embed 96,
depths 2/2/6/2, heads 3/6/12/24, window 7); ``build_linf`` builds any
pair of specs.  ``tiny=True`` gives the CPU test sizes (RRDB nf 8, nb 2,
gc 4; the flagship's tiny LINF).

``build_srflow_lp`` is the same for SRFlow-LP: the network_G and
prior_model of ``configs/srflow/SRFlow-LP_DF2K_4X.yml`` (RRDB nf 64,
nb 23, gc 32; K 16, L 3, hidden 64, stackRRDB [1, 8, 15, 22] concat,
fea_up0; prior UNet depth 3, dim 64, bilinear), with the flow made live
(``SRFlowNet.reset_parameters``); ``tiny=True`` gives
``tests/test_srflow.py``'s size (nf 8, nb 2, gc 4, K 2, hidden 8) with a
depth-2, dim-8 prior, which K3 (Cout 4) and K5 (hidden 8) do not take: it
runs on the CPU only.  ``build_srflow_prior_trainer`` is its prior trainer
(``srflow_train.py --prior`` on the same conf): the frozen flow, made
live as above, and its prior in train mode; ``example_srflow_train_batch``
a synthetic batch in the ``lrhr-pkl`` layout (``synthetic_lrhr_sample``:
smooth random 160^2 HR crops and their LQ by a 4x4 area mean, no PIL;
``scale=8``: an 8x8 mean).  ``build_srflow_x8`` is SRFlow's 8x model
(``bfsr_tpu_torch/configs/srflow_df2k_8x.yml``: the same network at scale
8 and L 4, no prior), made live the same way; ``build_srflow_x16`` the
16x one (``srflow_df2k_16x.yml``: scale 16, L 4, the same widths).
"""

import numpy as np
import torch
from torch import nn

import bfsr_tpu_torch.models  # noqa: F401  (registers the components)
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.data.np_interp import resize_bilinear_np
from bfsr_tpu_torch.data.wrappers import patch_centres, residuals
from bfsr_tpu_torch.models.base import seeded
from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
from bfsr_tpu_torch.utils.coords import make_cell, make_coord


def flagship_specs(tiny=False):
    """(linf spec, unet spec) of the flagship (or tiny) configuration."""
    if tiny:
        enc = {"name": "edsr-baseline",
               "args": {"n_resblocks": 2, "n_feats": 16, "no_upsampling": True}}
        margs = {"flow_layers": 3, "num_layer": 2, "hidden_dim": 32}
        pargs = {"in_chans": 3, "depth": 2, "dim": 16, "bilinear": True}
    else:
        enc = {"name": "edsr-baseline", "args": {"no_upsampling": True}}
        margs = {"flow_layers": 10, "num_layer": 3, "hidden_dim": 256}
        pargs = {"in_chans": 3, "depth": 3, "dim": 64, "bilinear": True}
    margs = {"encoder_spec": enc,
             "imnet_spec": {"name": "flow", "args": {"name": "flow"}}, **margs}
    return {"name": "linf", "args": margs}, {"name": "unet", "args": pargs}


@torch.no_grad()
def build_linf(linf_spec, prior_spec, device="cuda", seed=0):
    """(frozen LINF, frozen latent module) of the specs, eval mode, on
    ``device``, from ``seed``; the flow weights + I."""
    gen = seeded(seed)
    model = registry.make(linf_spec)
    model.reset_parameters(gen)
    for lin in [*model.imnet.linears, model.imnet.last]:
        lin._weight.add_(torch.eye(3))
    prior = registry.make(prior_spec)
    prior.reset_parameters(gen)
    model = model.to(device).eval().freeze()
    return model, prior.to(device).eval().freeze()


def build_flagship(device="cuda", seed=0, tiny=False):
    """(frozen LINF, UNet prior), eval mode, on ``device``."""
    return build_linf(*flagship_specs(tiny), device, seed)


def rrdb_linf_specs(tiny=False):
    """(linf spec, unet spec) of ``configs/train/train_rrdb-linf-LP.yaml``:
    the flagship's flow, MLP and UNet on an RRDB encoder (nf 64, nb 23,
    gc 32, ``no_upsampling``); ``tiny``: RRDB nf 8, nb 2, gc 4 and the
    flagship's tiny rest."""
    linf_spec, unet_spec = flagship_specs(tiny)
    rrdb = {"nf": 8, "nb": 2, "gc": 4} if tiny else {}
    linf_spec["args"]["encoder_spec"] = {
        "name": "rrdb", "args": {**rrdb, "no_upsampling": True}}
    return linf_spec, unet_spec


def _cpu_only(tiny, device, what):
    if tiny and torch.device(device).type == "cuda":
        raise ValueError(f"the tiny {what} config runs on the CPU only: K3 "
                         "takes Cout 8-64 and K2 hidden 128 or 256")


def build_rrdb_linf(device="cuda", seed=0, tiny=False):
    """(frozen RRDB-encoder LINF, UNet prior), eval mode, on ``device``:
    path (A), ``rrdb_linf_specs``."""
    _cpu_only(tiny, device, "RRDB-LINF")
    return build_linf(*rrdb_linf_specs(tiny), device, seed)


SWIN_PRIOR = {"name": "swin_latent", "args": {"in_chans": 3}}


def build_swin_prior(device="cuda", seed=0, tiny=False):
    """(frozen flagship LINF, ``swin_latent`` prior at the JAX package's
    widths: embed 96, depths 2/2/6/2, heads 3/6/12/24, window 7), eval
    mode, on ``device``: path (B).  ``tiny``: the flagship's tiny LINF
    (the latent module's widths are fixed)."""
    _cpu_only(tiny, device, "LINF")
    return build_linf(flagship_specs(tiny)[0], SWIN_PRIOR, device, seed)


def example_inputs(device, lr_hw, hr_hw, seed=0):
    """(inp, coord, cell, gt_lr_up) on ``device``: LR image and HR
    residual from ``np.random.default_rng(seed)``, as ``bench.py`` makes
    its workload."""
    rng = np.random.default_rng(seed)
    (h, w), (H, W) = lr_hw, hr_hw
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    gt_lr_up = (rng.random((1, H, W, 3)) - 0.5).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return (dev(inp), dev(make_coord((H, W), flatten=False)[None]),
            dev(make_cell((H, W))[None]), dev(gt_lr_up))


def entry(device="cuda", seed=0, tiny=False, lr_size=32, scale=4):
    """(fn, args): the learned-prior forward (encode z from the LR-up
    residual -> prior UNet -> flow inverse -> SR image) on ``device``."""
    model, prior = build_flagship(device, seed, tiny)
    predictor = LINFPredictor(model, prior)
    args = example_inputs(device, (lr_size, lr_size),
                          (lr_size * scale, lr_size * scale), seed)
    return predictor.predict, args


@torch.no_grad()
def build_flagship_trainer(device="cuda", seed=0, tiny=False):
    """(frozen LINF, UNet prior in train mode, frozen VGG19 features) on
    ``device``, from ``seed``."""
    device = torch.device(device)
    if tiny and device.type == "cuda":
        raise ValueError("the tiny trainer config runs on the CPU only: K2 "
                         "takes hidden 128 or 256")
    model, prior = build_flagship(device, seed, tiny)
    return model, prior.train(), he_normal_vgg(device, seed, tiny)


@torch.no_grad()
def he_normal_vgg(device, seed=0, tiny=False):
    """The frozen VGG19 features (through conv5_4, or conv2_2 with
    ``tiny``) with He-normal convs from ``seed + 1`` and zero biases."""
    vgg = registry.make({"name": "VGGFeatureExtractor",
                         "args": {"feature_layer": 8 if tiny else 34}})
    gen = seeded(seed + 1)
    for m in vgg.features:
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5,
                             generator=gen)
            m.bias.zero_()
    return vgg.to(device).eval().requires_grad_(False)


def _synthetic_crops(rng, n_lr, scale_max, scale):
    """A scale s ~ U(1, ``scale_max``) (or ``scale``), a smooth random HR
    image of round(``n_lr`` s)^2 in [0, 1] (a coarse random field, bilinear
    up, plus noise), its LR by a bilinear resize to ``n_lr``^2 (no PIL), an
    ``n_lr``^2 window of the HR grid: (LR, HR, the LR-up and HR residuals,
    the HR grid's coords, the window's slice), drawn from ``rng``."""
    n_hr = round(n_lr * (scale or rng.uniform(1, scale_max)))
    coarse = rng.random((max(2, n_hr // 8), max(2, n_hr // 8), 3))
    hr = np.clip(resize_bilinear_np(coarse, (n_hr, n_hr))
                 + 0.05 * rng.standard_normal((n_hr, n_hr, 3)), 0, 1)
    hr = hr.astype(np.float32)
    lr = resize_bilinear_np(hr, (n_lr, n_lr)).astype(np.float32)
    lr_up, lr_up_residual = residuals(lr, (n_hr, n_hr))
    hr_residual = ((hr - 0.5) / 0.5 - lr_up).astype(np.float32)
    y0, x0 = rng.integers(0, n_hr - n_lr + 1, 2)
    return (lr, hr, lr_up_residual, hr_residual,
            make_coord((n_hr, n_hr), flatten=False),
            np.s_[y0:y0 + n_lr, x0:x0 + n_lr])


def synthetic_train_sample(rng, inp_size=48, scale_max=4, scale=None):
    """One sample in the ``sr-implicit-downsampled-fast-crop`` layout from
    the numpy generator ``rng`` (``_synthetic_crops`` at an LR of
    ``inp_size``): the LR, and the window's coords, HR pixels, LR-up
    residual and HR residual, with the HR cell."""
    lr, hr, lr_up_residual, hr_residual, coord, sl = _synthetic_crops(
        rng, inp_size, scale_max, scale)
    return {"inp": lr, "coord": coord[sl], "cell": make_cell(hr.shape[:2]),
            "gt": hr[sl], "gt_lr_up": lr_up_residual[sl],
            "gt_pixel": hr_residual[sl]}


def example_train_batch(device, seed=0, batch=16, inp_size=48, scale_max=4):
    """A batch of ``synthetic_train_sample`` s from
    ``np.random.default_rng(seed)``, as float32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    samples = [synthetic_train_sample(rng, inp_size, scale_max)
               for _ in range(batch)]
    return {k: torch.as_tensor(np.stack([s[k] for s in samples]),
                               device=device) for k in samples[0]}


def synthetic_patch_train_sample(rng, inp_size=48, scale_max=4, scale=None,
                                 ps=3):
    """One sample in the ``sr-implicit-downsampled-fast-crop-patch`` layout
    from ``rng`` (``_synthetic_crops`` at an LR of ``inp_size`` ps): the LR,
    the window's HR pixels, and the wrapper's ``patch_centres`` of the
    residuals."""
    lr, hr, lr_up_residual, hr_residual, coord, sl = _synthetic_crops(
        rng, inp_size * ps, scale_max, scale)
    return {"inp": lr, "cell": make_cell(hr.shape[:2]), "gt": hr[sl],
            **patch_centres(lr_up_residual, hr_residual, coord, sl, ps)}


def example_patch_train_batch(device, seed=0, batch=16, inp_size=48,
                              scale_max=4):
    """A batch of ``synthetic_patch_train_sample`` s from
    ``np.random.default_rng(seed)``, as float32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    samples = [synthetic_patch_train_sample(rng, inp_size, scale_max)
               for _ in range(batch)]
    return {k: torch.as_tensor(np.stack([s[k] for s in samples]),
                               device=device) for k in samples[0]}


def srflow_specs(tiny=False):
    """(srflow spec, srflow-unet spec) of the SRFlow-LP flagship (or tiny)
    configuration."""
    if tiny:
        return ({"name": "srflow", "args": {
                    "nf": 8, "nb": 2, "gc": 4, "K": 2, "L": 3,
                    "hidden_channels": 8, "stack_blocks": (0, 1)}},
                {"name": "srflow-unet", "args": {"depth": 2, "dim": 8}})
    return ({"name": "srflow", "args": {
                "nf": 64, "nb": 23, "gc": 32, "K": 16, "L": 3,
                "hidden_channels": 64, "stack_blocks": (1, 8, 15, 22)}},
            {"name": "srflow-unet", "args": {"depth": 3, "dim": 64,
                                             "bilinear": True}})


def srflow_x8_spec(tiny=False):
    """The srflow spec of SRFlow's 8x model (``bfsr_tpu_torch/configs/
    srflow_df2k_8x.yml``: scale 8, L 4, the flagship's widths) or its tiny
    size."""
    spec, _ = srflow_specs(tiny)
    return {"name": "srflow", "args": {**spec["args"], "scale": 8, "L": 4}}


def srflow_x16_spec(tiny=False):
    """The srflow spec of SRFlow at 16x (``bfsr_tpu_torch/configs/
    srflow_df2k_16x.yml``: scale 16, L 4, the flagship's widths; K5 at the
    8x model's C = 12, 24, 48 and 192) or its tiny size."""
    spec, _ = srflow_specs(tiny)
    return {"name": "srflow", "args": {**spec["args"], "scale": 16, "L": 4}}


def _build_srflow(spec, device, seed, tiny):
    device = torch.device(device)
    if tiny and device.type == "cuda":
        raise ValueError("the tiny SRFlow config runs on the CPU only: K3 "
                         "takes Cout 8-64 and K5 hidden 64")
    model = registry.make(spec)
    model.reset_parameters(seeded(seed))
    return model.to(device).eval().freeze()


@torch.no_grad()
def build_srflow_x8(device="cuda", seed=0, tiny=False):
    """The frozen 8x SRFlowNet (``srflow_x8_spec``) with live random
    weights from ``seed`` (``SRFlowNet.reset_parameters``), eval mode, on
    ``device``."""
    return _build_srflow(srflow_x8_spec(tiny), device, seed, tiny)


@torch.no_grad()
def build_srflow_x16(device="cuda", seed=0, tiny=False):
    """The frozen 16x SRFlowNet (``srflow_x16_spec``), made as
    ``build_srflow_x8`` makes the 8x one."""
    return _build_srflow(srflow_x16_spec(tiny), device, seed, tiny)


def patch_specs(tiny=False):
    """(linf-patch spec, unet spec) of the patch configuration (or its
    tiny size)."""
    linf_spec, unet_spec = flagship_specs(tiny)
    linf_spec = {"name": "linf-patch",
                 "args": {**linf_spec["args"], "patch_size": 3}}
    unet_spec["args"]["in_chans"] = 27
    return linf_spec, unet_spec


@torch.no_grad()
def build_linf_patch(device="cuda", seed=0, tiny=False):
    """(frozen LINFPatch, frozen UNet prior), eval mode, on ``device``."""
    device = torch.device(device)
    if tiny and device.type == "cuda":
        raise ValueError("the tiny LINF-LP patch config runs on the CPU "
                         "only: K2 takes hidden 128 or 256")
    linf_spec, unet_spec = patch_specs(tiny)
    gen = seeded(seed)
    model = registry.make(linf_spec)
    model.reset_parameters(gen)
    eye = torch.eye(model.dim)
    for lin in [*model.imnet.linears, model.imnet.last]:
        lin._weight.mul_(0.05).add_(eye)
    prior = registry.make(unet_spec)
    prior.reset_parameters(gen)
    model = model.to(device).eval().freeze()
    return model, prior.to(device).eval().freeze()


@torch.no_grad()
def build_patch_trainer(device="cuda", seed=0, tiny=False):
    """(frozen LINFPatch, its UNet prior in train mode, frozen VGG19
    features) on ``device``, from ``seed``: the patch trainer."""
    model, prior = build_linf_patch(device, seed, tiny)
    return model, prior.train(), he_normal_vgg(device, seed, tiny)


def example_patch_inputs(device, lr_hw, grid_hw, seed=0):
    """(inp, coord, cell, gt_lr_up) of the ps = 3 patch model on
    ``device``: the LR image, the regular patch-centre grid ``grid_hw``
    (HR = 3 x grid) and a (1, Hq, Wq, 27) residual from
    ``np.random.default_rng(seed)``, as ``bench.py``'s patch workload makes
    them."""
    rng = np.random.default_rng(seed)
    (h, w), (Hq, Wq) = lr_hw, grid_hw
    inp = rng.random((1, h, w, 3)).astype(np.float32)
    gt_lr_up = (rng.random((1, Hq, Wq, 27)) - 0.5).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return (dev(inp), dev(make_coord((Hq, Wq), flatten=False)[None]),
            dev(make_cell((3 * Hq, 3 * Wq))[None]),
            dev(gt_lr_up))


@torch.no_grad()
def build_srflow_lp(device="cuda", seed=0, tiny=False):
    """(frozen SRFlowNet, frozen SRFlowUNet), eval mode, on ``device``."""
    device = torch.device(device)
    if tiny and device.type == "cuda":
        raise ValueError("the tiny SRFlow-LP config runs on the CPU only: "
                         "K3 takes Cout 8-64 and K5 hidden 64")
    flow_spec, prior_spec = srflow_specs(tiny)
    gen = seeded(seed)
    model = registry.make(flow_spec)
    model.reset_parameters(gen)
    prior = registry.make(prior_spec)
    prior.reset_parameters(gen)
    return (model.to(device).eval().freeze(),
            prior.to(device).eval().freeze())



@torch.no_grad()
def build_srflow_prior_trainer(device="cuda", seed=0, tiny=False):
    """(frozen SRFlowNet, its SRFlowUNet prior in train mode) on
    ``device``, from ``seed``: the SRFlow-LP prior trainer."""
    model, prior = build_srflow_lp(device, seed, tiny)
    return model, prior.train()


def synthetic_lrhr_sample(rng, gt_size=160, scale=4):
    """One ``lrhr-pkl`` sample from the numpy generator ``rng``: a smooth
    random HR crop of ``gt_size``^2 in [0, 1] (a coarse random field,
    bilinear up, plus noise) and its LQ, the mean of each ``scale`` x
    ``scale`` block (float32 HWC)."""
    n = gt_size // scale
    coarse = rng.random((max(2, gt_size // 8), max(2, gt_size // 8), 3))
    hr = np.clip(resize_bilinear_np(coarse, (gt_size, gt_size))
                 + 0.05 * rng.standard_normal((gt_size, gt_size, 3)), 0, 1)
    hr = hr.astype(np.float32)
    lq = hr.reshape(n, scale, n, scale, 3).mean((1, 3)).astype(np.float32)
    return {"GT": hr, "LQ": lq}


def example_srflow_train_batch(device, seed=0, batch=12, gt_size=160,
                               scale=4):
    """A batch of ``synthetic_lrhr_sample`` s at ``scale`` from
    ``np.random.default_rng(seed)``, as float32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    samples = [synthetic_lrhr_sample(rng, gt_size, scale)
               for _ in range(batch)]
    return {k: torch.as_tensor(np.stack([s[k] for s in samples]),
                               device=device) for k in samples[0]}


def dryrun_cases(n):
    """The three steps of ``dryrun_multichip(n)`` at the tiny configs on the
    CPU, as ``parallel.sharded.run_cases`` takes them: the LINF-LP dp x sp
    step (dp 2 where n is even, sp the rest; the HR rows a multiple of sp),
    the SRFlow NLL step and the SRFlow-LP prior step, both dp n."""
    from bfsr_tpu_torch.utils.coords import make_cell, make_coord

    rng = np.random.default_rng(0)
    dp = 2 if n % 2 == 0 and n > 1 else 1
    sp = n // dp
    b, h, s = max(2 * dp, 2), 8, 2
    H = max(h * s, 4 * sp)
    H = -(-H // sp) * sp
    coord = make_coord((H, H), flatten=False)
    linf = {
        "inp": rng.random((b, h, h, 3)).astype(np.float32),
        "coord": np.broadcast_to(coord, (b, H, H, 2)).copy(),
        "cell": np.broadcast_to(make_cell((H, H)), (b, 2)).copy(),
        "gt": rng.random((b, H, H, 3)).astype(np.float32),
        "gt_lr_up": (rng.random((b, H, H, 3)) - 0.5).astype(np.float32),
        "gt_pixel": (rng.random((b, H, H, 3)) - 0.5).astype(np.float32)}
    nll = {"GT": rng.random((4 * n, 16, 16, 3)).astype(np.float32),
           "LQ": rng.random((4 * n, 4, 4, 3)).astype(np.float32)}
    prior = {"GT": rng.random((4 * n, 32, 32, 3)).astype(np.float32),
             "LQ": rng.random((4 * n, 8, 8, 3)).astype(np.float32)}
    tiny = {"seed": 0, "tiny": True}
    return [
        {"step": "linf", "recipe": tiny, "batch": linf,
         "mesh": {"dp": dp, "sp": sp},
         "opts": {"vgg_weight": 1.0, "latent_weight": 0.5, "lr": 1e-4,
                  "adam": True}},
        {"step": "srflow_nll", "recipe": tiny, "batch": nll,
         "mesh": {"dp": n},
         "opts": {"rrdb_unfreeze_step": 0, "freeze_rrdb": False,
                  "lr": 1e-4, "adam": True}},
        {"step": "srflow_prior", "recipe": tiny, "batch": prior,
         "mesh": {"dp": n},
         "opts": {"eps_weight": 1.0, "image_weight": 1.0, "lr": 1e-3,
                  "adam": True}}]


def dryrun_spatial_case(n):
    """The spatial SRFlow predict of ``dryrun_multichip(n)``: one LR of 16
    x 8n from ``np.random.default_rng(0)`` (the JAX dry run's shape) on
    the tiny SRFlow and a ``srflow-unet`` prior of depth 2 and dim 8,
    its width over sp n (``parallel.sharded.run_predict``'s
    'srflow_sp')."""
    lr = np.random.default_rng(0).random((16, 8 * n, 3)).astype(np.float32)
    return {"predict": "srflow_sp", "recipe": {"seed": 0, "tiny": True},
            "inputs": {"lr": lr}, "mesh": {"sp": n}}


def dryrun_multichip(n, store_dir=None):
    """The twin of ``__graft_entry__.dryrun_multichip`` on ``n`` CPU ranks
    (``torch.distributed`` over gloo, ``parallel.mesh.spawn``, its store
    under ``store_dir``, else a temporary directory): one step of each of
    ``dryrun_cases(n)`` on the ranks, each held against the same step on
    this process (``parallel.sharded.check_against_single``: the loss
    within 1e-5 relative, the gradients within 1e-5 relative L2 or twice
    the step's own spread under a 1e-7 nudge of its input, the parameters
    after Adam within 1e-3) where the JAX dry run checks for finite values
    only; then the spatial SRFlow predict (``dryrun_spatial_case``), each
    rank's SR strip within 1e-5 of one process's
    (``parallel.sharded.compare_strips``).
    The two-process loader-fed run is ``profiling.multiproc_dryrun``.
    Prints each line and returns them; raises on a mismatch."""
    from bfsr_tpu_torch.parallel.mesh import spawn
    from bfsr_tpu_torch.parallel.sharded import (STRIP_TOL,
                                                 check_against_single,
                                                 compare_strips, run_cases)

    cases = dryrun_cases(n) + [dryrun_spatial_case(n)]
    ranks = spawn(run_cases, n, "gloo", args=(cases, "cpu"),
                  store_dir=store_dir)
    lines = []
    for i, case in enumerate(cases[:-1]):
        mesh = "x".join(f"{k}{v}" for k, v in case["mesh"].items())
        lines.append(check_against_single(
            case, [r[i] for r in ranks],
            f"dryrun_multichip(n={n}, mesh={mesh}): {case['step']} step",
            "cpu"))
    label = f"dryrun_multichip(n={n}, mesh=sp{n}): spatial SRFlow predict"
    got = [r[-1] for r in ranks]
    single = run_cases([dict(cases[-1], mesh=None, opts={"sp": n})],
                       "cpu")[0]
    errs = compare_strips(single, got, label)
    h, w = cases[-1]["inputs"]["lr"].shape[:2]
    lines.append(
        f"{label}: LR {h}x{w} -> SR {single['image'].shape[0]}x"
        f"{single['image'].shape[1]}, {n} strips of "
        f"{tuple(got[0]['out'].shape[1:3])}; each rank's strip within "
        f"{max(errs):.3e} of one process (tol {STRIP_TOL:g}); "
        f"{got[0]['exchanges']} halo exchanges, {got[0]['bytes']} bytes a "
        "rank")
    for line in lines:
        print(line)
    return lines
