"""SRFlow-LP learned-prior inference, SRFlow validation and sampling, on
one device.

The counterpart of ``bfsr_tpu/pipelines/srflow_eval.py``'s
``SRFlowLPPredictor``, ``validate`` and ``sample_sr``.  ``validate`` (the
reference's ``SRFlowModel.test()``) and ``sample_sr`` first ``freeze()``
the model on its current weights (a trainer's weights move: K5's packs
and K3's layouts would be stale), then run the RRDB once a batch (K3) and
decode each heat x sample on K5's reverse, each split's eps drawn from a
``torch.Generator`` seeded per batch (``seed + batch index``) on the
model's device; ``validate``'s NLL runs on the unfused log-det encode
(``normal_flow_nll``: K5 drops the log-det).  ``kernels=False`` or
``TWINS`` runs the same on the twins.

``SRFlowSpatialPredictor`` runs the same chain on one image whose width
is split over ranks, each rank's strip with its neighbours' columns at
every op with a spatial extent (``ops.nn.width_sharded``).

The predictor, per LR image (batch 1):

1. pad H and W to a multiple of ``pad_multiple`` (the protocol's 2 at
   least): reflect-pad to even, or for a larger multiple, as the JAX
   predictor does, pad with the image's mirror (numpy's 'symmetric');
2. bilinear up x4 (the image the flow encodes);
3. the RRDB conditioning (K3 on CUDA for the dense blocks) with the
   nearest-up block stack appended (320 channels at the flagship);
4. every conditional step's record, once (``precompute_ft``);
5. encode the LR-up image with no quantisation noise (48 K5 launches at
   the flagship);
6. standardise each eps per pixel over channels (ddof=1);
7. the two-branch UNet prior (K3 at full resolution);
8. decode the learned epses (48 K5 launches);
9. clip to [0, 1] and crop back to the unpadded image's SR.

``kernels=True`` runs each stage's kernel wrapper (the CUDA kernel for a
CUDA tensor, the plain twin for a CPU tensor); ``kernels=False`` runs the
plain twins and the unfused flow steps on any device, the reference the
kernel path is held to.  The kernels take any extent: a larger
``pad_multiple`` buckets shapes for the JAX compiler and here only
changes the border, as there.

Precision modes (``ops/nn.py``): step 7 is the ``prior`` stage, so under
``mixed`` the prior's convs take bf16 operands (its 18 full-resolution
convs on the bf16 K3) while the RRDB, the conditioning and K5 stay f32.
Under ``default`` every stage is bf16: the RRDB's 345 dense-block convs
on the bf16 K3 and its other convs through ``fnn.conv2d``, the
conditioning records (``cond_affine_cache_batched``), the split's conv,
the 96 conditional steps on K5's one-pass form and the prior as under
``mixed``; the unconditional steps' folded actnorm + invconv stays f32,
as in the JAX package.  The one-pass form is the one the flow was frozen
with (``SRFlowNet.freeze(step_form=...)``): ``"xla"`` by default, the JAX
predictor's numerics (the folds f32, as its XLA step), or ``"pallas"``,
the JAX FlowStep kernel's.
"""

import numpy as np
import torch
import torch.nn.functional as F

from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import TWINS
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.pipelines.linf_train import to_device
from bfsr_tpu_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw
from bfsr_tpu_torch.parallel.collective import gather_rows

STAGES = ("rrdb", "precompute_ft", "encode", "prior", "decode")


def check_prior_flow(model):
    """Refuse a flow the two-branch prior does not read: it takes [the eps
    of the one split, z_final], the epses of an L 3 flow.  At L 4 (the 8x
    model) the flow has two splits and its second eps is the 12-channel
    split latent, not z_final: the JAX ``SRFlowLPPredictor`` fails there
    with a reshape ``TypeError`` (ROADMAP.md queue 3)."""
    if model.L != 3:
        raise ValueError(
            f"SRFlow-LP's two-branch prior is defined for an L 3 flow (one "
            f"split: epses [eps0, z]); this flow has L={model.L} "
            f"({len([e for e in model.plan if e['kind'] == 'split'])} "
            "splits). Serve it with sample_sr / get_sr or validate, without "
            "a prior (ROADMAP.md queue 3)")


def pad_to_multiple(lr_img01, multiple=2):
    """(h, w, 3) -> (1, h', w', 3), h' and w' the next multiples of
    ``multiple`` (at least 2), padded at the bottom and right: reflected
    for the protocol's %2 pad, mirrored with the edge (numpy's
    'symmetric', up to the image's size) for a larger multiple."""
    m = max(2, int(multiple or 2))
    h, w = lr_img01.shape[:2]
    x = lr_img01[None].float()
    if m == 2:
        if h % 2 or w % 2:
            x = nchw_to_nhwc(F.pad(nhwc_to_nchw(x), (0, w % 2, 0, h % 2),
                                   mode="reflect"))
        return x
    return pad_symmetric(x, -(-h // m) * m, -(-w // m) * m)


def pad_symmetric(x, hp, wp):
    """(B, h, w, C) -> (B, hp, wp, C), padded at the bottom and right with
    the image's mirror, edge included (numpy's 'symmetric'; pads up to
    the image's size)."""
    x = torch.cat([x, x.flip(1)], 1)[:, :hp]
    return torch.cat([x, x.flip(2)], 2)[:, :, :wp].contiguous()


class SRFlowLPPredictor:
    """Whole-image predictor for a frozen SRFlowNet and its prior."""

    def __init__(self, model, prior_model, kernels=True, pad_multiple=2):
        if not model.flowUpsamplerNet.frozen():
            raise ValueError("freeze() the SRFlow model before predicting")
        check_prior_flow(model)
        self.model = model
        self.prior = prior_model
        self.kernels = kernels
        self.pad_multiple = max(2, int(pad_multiple or 2))

    @torch.inference_mode()
    def run(self, lr, mark=None):
        """lr: (1, h, w, 3) with h, w even (``pad_to_multiple``) -> the SR image (1, 4h, 4w, 3),
        unclipped.  ``mark(stage, out)``, if given, is called after each of
        ``STAGES`` with what it made (the RRDB's maps, the records, the
        epses, the learned epses, the SR image)."""
        model, k = self.model, self.kernels
        mark = mark or (lambda stage, out: None)
        s = model.scale
        h, w = lr.shape[1], lr.shape[2]
        lr_up = resize_bilinear(lr, (h * s, w * s))
        lr_enc = model.rrdb_preprocess(lr, kernels=k)
        mark("rrdb", lr_enc)
        cache = model.precompute_ft(lr_enc)
        mark("precompute_ft", cache)
        epses = model.normal_flow(lr_up, cache, kernels=k)
        mark("encode", epses)
        with fnn.stage("prior"):
            learned = self.prior(standardize_epses(epses), kernels=k)
        mark("prior", learned)
        sr = model.reverse_flow(learned, cache, kernels=k)
        mark("decode", sr)
        return sr

    @torch.inference_mode()
    def predict(self, lr_img01):
        """lr_img01: (h, w, 3) [0, 1] image (a tensor, or a numpy array,
        which goes to the model's device).  Returns the SR image
        (4h, 4w, 3), clipped to [0, 1]."""
        if isinstance(lr_img01, np.ndarray):
            dev = next(self.model.parameters()).device
            lr_img01 = torch.as_tensor(lr_img01, dtype=torch.float32,
                                       device=dev)
        h, w = lr_img01.shape[:2]
        sr = self.run(pad_to_multiple(lr_img01, self.pad_multiple))
        s = self.model.scale
        return torch.clamp(sr[0], 0.0, 1.0)[: h * s, : w * s]


class SRFlowSpatialPredictor:
    """One LR image's width split over the ranks of a mesh axis: the
    counterpart of ``bfsr_tpu/pipelines/srflow_eval.py:
    SRFlowSpatialPredictor``, whose partitioner puts a halo exchange at
    every conv; here ``ops.nn.width_sharded`` and ``ops/halo.py`` do
    (the module docstring of ``ops/nn.py`` lists the sites).

    ``mesh``: a ``parallel.mesh`` mesh; ``axis``: the axis whose ranks
    share the image (an axis of size 1, or absent, is one strip).
    ``predict`` pads H to a multiple of 2 and W to a multiple of
    ``multiple`` = ``count * max(8, 2 ** (prior.depth + 1))``, both with
    the image's mirror (numpy's 'symmetric', as the JAX ``predict``), so
    that the strips are equal and every squeeze, pool and x2 upsample of
    the prior divides a strip evenly: 8 per rank, as the JAX predictor
    pads, up to a prior of depth 2; 16 at the flagship's depth 3, so that
    its third pool still halves an even strip.  ``run`` takes this
    rank's LR strip and returns its SR strip (unclipped), the chain of
    ``SRFlowLPPredictor.run`` under the scope; ``predict`` gathers the
    strips, clips and crops (every rank returns the whole image).  L != 3
    raises (``check_prior_flow``)."""

    def __init__(self, model, prior_model, mesh, axis="sp", kernels=True):
        self.single = SRFlowLPPredictor(model, prior_model, kernels)
        self.model = model
        self.count, self.index = mesh.size(axis), mesh.index(axis)
        self.group = mesh.group(axis) if self.count > 1 else None
        self.multiple = strip_multiple(self.count, prior_model)

    def pad(self, lr_img01):
        """``pad_strips`` at ``multiple``."""
        return pad_strips(lr_img01, self.multiple)

    def strip(self, x):
        """This rank's columns of a whole-width (B, H, W, C) tensor."""
        w = x.shape[2] // self.count
        return x[:, :, self.index * w:(self.index + 1) * w].contiguous()

    @torch.inference_mode()
    def run(self, lr_strip, mark=None):
        """This rank's strip (1, h, w, 3) of the padded LR -> its SR strip
        (1, 4h, 4w, 3), unclipped (``mark`` as ``SRFlowLPPredictor.run``)."""
        with fnn.width_sharded(self.group, self.index, self.count):
            return self.single.run(lr_strip, mark)

    @torch.inference_mode()
    def gather(self, sr_strip, h, w):
        """The ranks' SR strips side by side, clipped to [0, 1] and cropped
        to the unpadded (s h, s w, 3)."""
        if self.group is not None:
            sr_strip = gather_rows(sr_strip, self.group, dim=2)
        s = self.model.scale
        return torch.clamp(sr_strip[0], 0.0, 1.0)[: h * s, : w * s]

    def predict(self, lr_img01):
        """lr_img01: (h, w, 3) [0, 1] image (a tensor, or a numpy array,
        which goes to the model's device), the same on every rank.
        Returns the SR image (4h, 4w, 3), clipped."""
        if isinstance(lr_img01, np.ndarray):
            dev = next(self.model.parameters()).device
            lr_img01 = torch.as_tensor(lr_img01, dtype=torch.float32,
                                       device=dev)
        h, w = lr_img01.shape[:2]
        return self.gather(self.run(self.strip(self.pad(lr_img01))), h, w)


def strip_multiple(count, prior):
    """The LR width multiple of ``count`` strips under the two-branch
    prior ``prior`` (``SRFlowSpatialPredictor``)."""
    return count * max(8, 2 ** (prior.depth + 1))


def pad_strips(lr_img01, multiple):
    """(h, w, 3) -> (1, h', w', 3): h' even, w' a multiple of
    ``multiple``, mirrored at the bottom and right (``pad_symmetric``), as
    the JAX spatial predictor pads."""
    h, w = lr_img01.shape[:2]
    return pad_symmetric(lr_img01[None].float(), -(-h // 2) * 2,
                         -(-w // multiple) * multiple)


def lr_multiple(model):
    """The LR multiple a flow of scale s and L levels decodes: its final
    latent is at s h / 2^L (at least 2, the protocol's pad)."""
    return max(2, 2 ** model.L // model.scale)


def _refreeze(model):
    """``freeze()`` on the current weights, in the one-pass form the flow
    was frozen with."""
    steps = model.flowUpsamplerNet.steps()
    return model.freeze(steps[0].step_form if steps else "xla")


@torch.no_grad()
def validate(model, batches, heats=(0.0, 0.5, 0.75, 1.0), n_sample=3, seed=0,
             kernels=True):
    """SRFlow validation (``SRFlow_model.py:178-189``): SR samples at each
    heat x ``n_sample`` and the mean NLL of GT (with its quantisation
    noise), in bits/dim.

    batches: an iterable of {'GT': (B, H, W, 3), 'LQ': (B, H/s, W/s, 3)}
    at scale s (numpy arrays or tensors; H, W divisible by 2^L).  Returns
    (the mean over batches of each batch's mean NLL, {(heat, i): the first image of
    the last batch's sample i at heat, clipped to [0, 1]})."""
    path = True if kernels is True else TWINS
    _refreeze(model)
    dev = next(model.parameters()).device
    nlls, samples = [], {}
    for bi, batch in enumerate(batches):
        batch = to_device(batch, dev, ("GT", "LQ"))
        lq, gt = batch["LQ"], batch["GT"]
        gen = torch.Generator(device=dev).manual_seed(seed + bi)
        # the conditioning once a batch, shared by every sample and the NLL
        cache = model.precompute_ft(model.rrdb_preprocess(lq, path))
        for heat in heats:
            for i in range(n_sample):
                z = model.sample_z(heat, lq.shape[1:3], lq.shape[0], gen, dev)
                sr = model.reverse_flow([z], cache, path, eps_std=heat,
                                        generator=gen)
                samples[(heat, i)] = torch.clamp(sr[0], 0.0, 1.0)
        _, nll, _ = model.normal_flow_nll(gt, cache, generator=gen)
        nlls.append(float(nll.mean()))
    return float(np.mean(nlls)), samples


@torch.no_grad()
def sample_sr(model, lr_img01, heat=0.0, seed=0, kernels=True):
    """An SR sample of one LR image (h, w, 3) in [0, 1] at temperature
    ``heat`` (``SRFlow_model.get_sr``): padded to the multiple the flow's
    last level needs (``lr_multiple``: reflect-padded to even at x4 L 3 and
    x8 L 4), decoded on K5 from a final latent and each split's eps drawn
    from a generator seeded with ``seed``, clipped and cropped to (s h, s
    w, 3) at scale s."""
    path = True if kernels is True else TWINS
    _refreeze(model)
    dev = next(model.parameters()).device
    if isinstance(lr_img01, np.ndarray):
        lr_img01 = torch.as_tensor(lr_img01, dtype=torch.float32, device=dev)
    h, w = lr_img01.shape[:2]
    lr = pad_to_multiple(lr_img01.to(dev), lr_multiple(model))
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = model.sample_z(heat, lr.shape[1:3], 1, gen, dev)
    sr = model.get_sr(lr, heat, z=z, generator=gen, kernels=path)
    s = model.scale
    return torch.clamp(sr[0], 0.0, 1.0)[: h * s, : w * s]
