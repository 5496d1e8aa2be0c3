"""SRFlowNet: RRDB conditioning + FlowUpsamplerNet, NLL in bits/dim.

The counterpart of ``bfsr_tpu/models/srflow/srflow_net.py``, registered
as ``'srflow'``:

* ``rrdb_preprocess`` runs the RRDB trunk with taps and, under
  ``stack_concat``, appends the nearest-resized stack of blocks
  ``stack_blocks`` to every conditioning map (64 + 4 * 64 = 320 channels
  at the flagship; ``nf`` without the stack);
* the configurations: scale 4 at L 3 (the flagship) or L 4 (the last
  level on ``fea_up-1``, ``fea_upm1``), scale 8 at L 4 (SRFlow's 8x
  model: levels on ``fea_up4``, ``fea_up2``, ``fea_up1``, ``fea_up0``, two
  splits, a 192-channel final latent) and scale 16 at L 4 (levels on
  ``fea_up8``, ``fea_up4``, ``fea_up2``, ``fea_up1``: ``build_plan`` gives
  the 8x model's widths, C = 12, 24, 48 and 192).  A level whose map is
  switched off (``fea_up0`` / ``fea_upm1``, which the JAX model meets
  with a ``KeyError``) and a level past ``LEVEL_NAMES`` raise at
  construction;
* ``precompute_ft`` builds every conditional step's record once per batch
  (``differentiable=True``: records autograd differentiates, the
  trainer's);
* ``normal_flow`` encodes a batch of HR images to their epses (no
  quantisation noise, no log-det: the eval path, on K5) and
  ``reverse_flow`` decodes epses to the SR images (``differentiable=True``:
  autograd differentiates it with respect to the epses; ``eps_std`` and a
  ``generator``: from the final latent alone, each split's eps drawn);
* ``normal_flow_nll`` is the NLL path (``SRFlowNet_arch.py:83-116``): the
  quantisation noise ``(U - 0.5) / quant`` (from a generator, or the
  ``noise`` the caller passes) and ``-log(quant) * pixels``, the log-det
  encode (unfused, on the live weights, differentiable), the NLL in
  bits/dim; ``reverse_flow_logdet`` the decode with its log-det;
  ``get_sr`` an SR sample at any heat, ``sample_z`` the final latent of a
  batch;
* ``prime_actnorms`` primes a random flow's actnorms from a batch;
  ``standardize_epses`` is the per-pixel channel standardisation of the
  learned-prior path.

``freeze()`` caches what the kernels and the float64 folds need (RRDB
dense blocks in K3's layout, the flow's folds and K5 buffers); call it
after moving the model to its device and after changing weights (the
kernel paths raise on layouts older than the weights).  The submodules
are named ``RRDB`` and ``flowUpsamplerNet``, as the reference's
``state_dict`` names them.
"""

import math

import torch

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.rrdb import RRDBNet
from bfsr_tpu_torch.models.srflow.flow_upsampler import (LEVEL_NAMES,
                                                         FlowUpsamplerNet,
                                                         build_plan)
from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.interp import resize_nearest
from bfsr_tpu_torch.registry import register


def rrdb_preprocess(rrdb, lr, block_idxs, keys, kernels=True, conv=None,
                    concat=True):
    """RRDB taps + the pyramid maps ``keys``, with (``concat`` and blocks
    to stack) the nearest-resized stack of the blocks ``block_idxs``
    appended to each (``conv``: as ``RRDBNet.forward``).  The JAX
    function appends it to every map it computes (``fea_up8`` and
    ``fea_up16`` too at 16x); here only the maps the flow reads are
    computed, each with the stack."""
    res = rrdb.steps(lr, keys, block_idxs, kernels, conv)
    if not (block_idxs and concat):
        return res
    stack = torch.cat([res[f"block_{i}"] for i in block_idxs], -1)
    for k in keys:
        h, w = res[k].shape[1], res[k].shape[2]
        res[k] = torch.cat([res[k], resize_nearest(stack, (h, w))], -1)
    return res


def check_config(scale, L, fea_up0, fea_upm1):
    """Refuse what the port does not run: a scale or level with no
    conditioning map, and a level whose map is switched off."""
    if scale not in LEVEL_NAMES:
        raise ValueError(f"SRFlow runs at scale {tuple(LEVEL_NAMES)}, got "
                         f"{scale}")
    names = LEVEL_NAMES[scale]
    for lvl in range(1, L + 1):
        if lvl not in names:
            raise ValueError(f"scale {scale} has conditioning maps for "
                             f"levels 1-{max(names)}, not L={L}")
        for key, on, flag in (("fea_up0", fea_up0, "fea_up0"),
                              ("fea_up-1", fea_upm1, "fea_upm1")):
            if names[lvl] == key and not on:
                raise ValueError(f"level {lvl} at scale {scale}, L={L} reads "
                                 f"{key}: set {flag}")


def standardize_epses(epses, eps=1e-8):
    """Per-pixel channel standardisation (torch.std, ddof=1), each pixel
    of each image on its own."""
    out = []
    for e in epses:
        mean = e.mean(-1, keepdim=True)
        std = e.std(-1, keepdim=True)
        out.append((e - mean) / (std + eps))
    return out


@register("srflow")
class SRFlowNet(Model):
    registry_name = "srflow"

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=23, gc=32, scale=4, K=16,
                 L=3, hidden_channels=64, additional_steps=2,
                 split_enable=True, stack_blocks=(1, 8, 15, 22),
                 stack_concat=True, fea_up0=True, fea_upm1=False, quant=32):
        super().__init__()
        check_config(scale, L, fea_up0, fea_upm1)
        self.args = dict(in_nc=in_nc, out_nc=out_nc, nf=nf, nb=nb, gc=gc,
                         scale=scale, K=K, L=L,
                         hidden_channels=hidden_channels,
                         additional_steps=additional_steps,
                         split_enable=split_enable,
                         stack_blocks=tuple(stack_blocks),
                         stack_concat=stack_concat, fea_up0=fea_up0,
                         fea_upm1=fea_upm1, quant=quant)
        self.scale, self.L, self.quant = scale, L, quant
        self.stack_blocks = tuple(stack_blocks)
        self.stack_concat = stack_concat
        self.plan, self.final_c = build_plan(scale, L, K, additional_steps,
                                             split_enable, base_c=in_nc)
        cond_channels = ((len(stack_blocks) + 1) * nf if stack_concat
                         else nf)
        self.RRDB = RRDBNet(in_nc, out_nc, nf, nb, gc, no_upsampling=False,
                            scale=scale)
        self.flowUpsamplerNet = FlowUpsamplerNet(self.plan, cond_channels,
                                                 hidden_channels)
        self.reset_parameters(seeded(0), live=False)

    @torch.no_grad()
    def reset_parameters(self, generator, live=True):
        """Random weights: the RRDB as ``init_rrdb``; each invconv a QR
        orthogonal matrix; the flow convs N(0, 0.05) (``weight_std``), the
        zero-initialised tails (Conv2dZeros) and the actnorms zero, as the
        reference initialises them.

        ``live=True`` (the default) makes the flow live: with zero tails
        the coupling is a constant (scale = sigmoid(2) + 1e-4, shift 0)
        whatever the conditioning.  The coupling tails get
        N(0, 0.25 / sqrt(fan_in)) weights and the split's N(0, 0.1 /
        sqrt(fan_in)) (its logs channels set exp(logs) of the decoded
        half), both N(0, 0.05) biases, the tail logs and every actnorm's
        bias and logs N(0, 0.1), and the flow convs N(0, 1 / sqrt(fan_in))
        in place of the fixed 0.05, so that each conv keeps its input's
        scale at any width.  The reference's actnorms whiten their inputs
        from the first batch; these are not primed, and a random RRDB's
        features grow ~1.2x per block (to RMS ~10 at nb 23), which
        saturates the sigmoids and overflows the 48-step inverse.  So the
        conditioning-facing part of each tower's first conv is divided by
        the RMS of its level's conditioning map on one LR image drawn from
        ``generator`` (16 x 16, uniform [0, 1]).  And the scale channels of
        each coupling tail (the odd ones of the 'cross' split) get +2 on
        their bias, so that scale = sigmoid(o + 2) + 1e-4 sits near
        sigmoid(4) = 0.98, as in a flow near the identity: at sigmoid(2) =
        0.88 every inverse step expands its input ~1.25-fold, and the
        48-step decode amplifies float32 roundoff ~1e4-fold."""
        self.RRDB.reset_parameters(generator)

        def normal_(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        split_convs = [m.conv for m in self.flowUpsamplerNet.modules()
                       if isinstance(m, flows.Split2d)]
        for m in self.flowUpsamplerNet.modules():
            if isinstance(m, flows.InvConv1x1):
                q, r = torch.linalg.qr(torch.randn(m.weight.shape,
                                                   generator=generator))
                m.weight.copy_(q * torch.sign(torch.diagonal(r))[None, :])
            elif isinstance(m, flows.FlowConv):
                fan_in = m.weight[0].numel()
                normal_(m.weight, fan_in ** -0.5 if live else 0.05)
            elif isinstance(m, flows.FlowConvZeros):
                gain = 0.1 if any(m is c for c in split_convs) else 0.25
                stds = ((m.weight, gain * m.weight[0].numel() ** -0.5),
                        (m.bias, 0.05), (m.logs, 0.1))
                for t, std in stds:
                    if live:
                        normal_(t, std)
                    else:
                        t.zero_()
            elif isinstance(m, flows.ActNorm):
                for t in (m.bias, m.logs):
                    if live:
                        normal_(t, 0.1)
                    else:
                        t.zero_()
        if not live:
            return
        lr = torch.rand((1, 16, 16, 3), generator=generator)
        conds = self._conds(self.rrdb_preprocess(
            lr.to(self.RRDB.conv_first.weight.device), kernels=False))
        for e, m in zip(self.plan, self.flowUpsamplerNet.layers):
            if e["kind"] == "step_cond":
                rms = conds[e["level"]].square().mean().sqrt()
                c_ft = conds[e["level"]].shape[-1]
                for tower in (m.affine.fFeatures, m.affine.fAffine):
                    tower[0].weight[:, -c_ft:] /= rms
                    tower[4].bias[1::2] += 2.0

    @torch.no_grad()
    def freeze(self, step_form="xla"):
        """``step_form``: the one-pass K5 form served under ``default``
        (``FlowUpsamplerNet.freeze``)."""
        self.RRDB.freeze()
        self.flowUpsamplerNet.freeze(step_form)
        return self

    def cond_keys(self):
        names = LEVEL_NAMES[self.scale]
        return [names[lvl] for lvl in range(1, self.L + 1)]

    def rrdb_preprocess(self, lr, kernels=True, conv=None):
        """The conditioning maps the flow reads (and the block taps)."""
        return rrdb_preprocess(self.RRDB, lr, self.stack_blocks,
                               self.cond_keys(), kernels, conv,
                               self.stack_concat)

    def _conds(self, lr_enc):
        names = LEVEL_NAMES[self.scale]
        return {lvl: lr_enc[names[lvl]] for lvl in range(1, self.L + 1)}

    def precompute_ft(self, lr_enc, differentiable=False):
        return self.flowUpsamplerNet.precompute_ft(self._conds(lr_enc),
                                                   differentiable)

    @torch.no_grad()
    def prime_actnorms(self, gt, lr):
        """Data-dependent actnorm init from one (gt (B, H, W, 3), lr (B,
        H/s, W/s, 3)) batch, as ``bfsr_tpu/models/srflow/srflow_net.py:
        prime_actnorms`` (the reference's ``FlowActNorms.py:45-59``), then
        ``freeze()`` again, the same ``step_form``.  Only meaningful on a
        random flow (``flowUpsamplerNet.actnorms_unprimed()``)."""
        conds = self._conds(self.rrdb_preprocess(lr))
        self.flowUpsamplerNet.prime_actnorms(gt, conds)
        steps = self.flowUpsamplerNet.steps()
        return self.freeze(steps[0].step_form if steps else "xla")

    def normal_flow(self, gt, cache, kernels=True):
        """Encode gt (B, H, W, 3) -> [the eps of each split..., z_final], no
        noise, no log-det."""
        return self.flowUpsamplerNet.encode(gt, cache, kernels)

    def reverse_flow(self, epses, cache, kernels=True, differentiable=False,
                     eps_std=None, generator=None):
        """Decode [the eps of each split..., z_final] -> the SR images (B,
        H, W, 3); from ``[z_final]`` alone each split's eps is drawn from
        ``generator`` times ``eps_std`` (zeros with no generator)."""
        return self.flowUpsamplerNet.decode(epses, cache, kernels,
                                            differentiable, eps_std,
                                            generator)

    def normal_flow_nll(self, gt, cache, noise=None, generator=None):
        """(epses, nll, logdet) of gt (B, H, W, 3) on the unfused log-det
        encode.  gt gets the quantisation noise ``noise`` (B, H, W, 3) or,
        if None, ``(U - 0.5) / quant`` with U drawn from ``generator`` (in
        a data-parallel step the global batch's draw, this rank's rows:
        ``fnn.global_rows``), and
        the log-det ``-log(quant) * H W``; nll is ``-(logdet + log
        N(z_final)) / (log 2 * H W)`` per image."""
        pixels = gt.shape[1] * gt.shape[2]
        if noise is None:
            noise = fnn.global_rows(lambda n: (torch.rand(
                (n, *gt.shape[1:]), generator=generator, device=gt.device)
                - 0.5) / self.quant, gt.shape[0])
        logdet = torch.full((gt.shape[0],), -math.log(self.quant) * pixels,
                            device=gt.device)
        epses, logdet = self.flowUpsamplerNet.encode_logdet(gt + noise, cache,
                                                            logdet)
        objective = logdet + flows.gaussian_logp(epses[-1])
        return epses, -objective / (math.log(2.0) * pixels), logdet

    def reverse_flow_logdet(self, epses, cache):
        """(SR images, logdet): ``reverse_flow`` unfused on the live
        weights, with the log-det (from ``+log(quant) * H W``)."""
        z = epses[-1]
        pixels = z.shape[1] * z.shape[2] * 4 ** self.L
        logdet = torch.full((z.shape[0],), math.log(self.quant) * pixels,
                            device=z.device)
        return self.flowUpsamplerNet.decode_logdet(epses, cache, logdet)

    def sample_z(self, heat, lr_hw, batch_size=1, generator=None,
                 device=None):
        """The final latent (batch_size, s*h/2^L, s*w/2^L, final_c): zeros
        at heat 0, else N(0, heat^2) drawn from ``generator``."""
        h = self.scale * lr_hw[0] // 2 ** self.L
        w = self.scale * lr_hw[1] // 2 ** self.L
        shape = (batch_size, h, w, self.final_c)
        if not heat:
            return torch.zeros(shape, device=device)
        return torch.randn(shape, generator=generator, device=device) * heat

    def get_sr(self, lq, heat=None, z=None, epses=None, generator=None,
               kernels=True):
        """SR samples of lq (B, h, w, 3): decode ``epses``, or ``z``, or a
        final latent from ``sample_z`` at ``heat``, each split's eps drawn
        at ``heat`` from ``generator`` (``SRFlow_model.get_sr``).  The
        steps run on K5 with ``kernels`` (a frozen model)."""
        cache = self.precompute_ft(self.rrdb_preprocess(lq, kernels))
        if epses is None:
            if z is None:
                z = self.sample_z(heat, lq.shape[1:3], lq.shape[0],
                                  generator, lq.device)
            epses = [z]
        return self.reverse_flow(epses, cache, kernels, eps_std=heat,
                                 generator=generator)
