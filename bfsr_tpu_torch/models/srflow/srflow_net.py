"""SRFlowNet: RRDB conditioning + FlowUpsamplerNet, eval (no NLL).

The counterpart of ``bfsr_tpu/models/srflow/srflow_net.py``, registered
as ``'srflow'``:

* ``rrdb_preprocess`` runs the RRDB trunk with taps and appends the
  nearest-resized stack of blocks ``stack_blocks`` to every conditioning
  map (64 + 4 * 64 = 320 channels at the flagship);
* ``precompute_ft`` builds every conditional step's record once per batch;
* ``normal_flow`` encodes a batch of HR images to their epses (no
  quantisation noise, no log-det) and ``reverse_flow`` decodes epses to
  the SR images (``differentiable=True``: autograd differentiates it with
  respect to the epses);
* ``prime_actnorms`` primes a random flow's actnorms from a batch;
* ``sample_z`` gives the final latent's shape; ``standardize_epses`` the
  per-pixel channel standardisation of the learned-prior path.

``freeze()`` caches what the kernels and the float64 folds need (RRDB
dense blocks in K3's layout, the flow's folds and K5 buffers); call it
after moving the model to its device and after changing weights.  The
submodules are named ``RRDB`` and ``flowUpsamplerNet``, as the
reference's ``state_dict`` names them.
"""

import torch

from bfsr_tpu_torch.models.base import Model, seeded
from bfsr_tpu_torch.models.rrdb import RRDBNet
from bfsr_tpu_torch.models.srflow.flow_upsampler import (LEVEL_NAMES,
                                                         FlowUpsamplerNet,
                                                         build_plan)
from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops.interp import resize_nearest
from bfsr_tpu_torch.registry import register


def rrdb_preprocess(rrdb, lr, block_idxs, keys, kernels=True, conv=None):
    """RRDB taps + pyramid, with the nearest-resized stack of the blocks
    ``block_idxs`` appended to each map in ``keys`` (``conv``: as
    ``RRDBNet.forward``)."""
    res = rrdb(lr, block_idxs=block_idxs, kernels=kernels, conv=conv)
    stack = torch.cat([res[f"block_{i}"] for i in block_idxs], -1)
    for k in keys:
        h, w = res[k].shape[1], res[k].shape[2]
        res[k] = torch.cat([res[k], resize_nearest(stack, (h, w))], -1)
    return res


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
        if (scale != 4 or L != 3 or fea_upm1 or not fea_up0
                or not stack_concat or not stack_blocks):
            raise NotImplementedError("the port runs the SRFlow-LP 4x config "
                                      "(scale 4, L 3, stacked concat, "
                                      "fea_up0)")
        self.args = dict(in_nc=in_nc, out_nc=out_nc, nf=nf, nb=nb, gc=gc,
                         scale=scale, K=K, L=L,
                         hidden_channels=hidden_channels,
                         additional_steps=additional_steps,
                         split_enable=split_enable,
                         stack_blocks=tuple(stack_blocks),
                         stack_concat=stack_concat, fea_up0=fea_up0,
                         fea_upm1=fea_upm1, quant=quant)
        self.scale, self.L = scale, L
        self.stack_blocks = tuple(stack_blocks)
        self.plan, self.final_c = build_plan(scale, L, K, additional_steps,
                                             split_enable, base_c=in_nc)
        cond_channels = (len(stack_blocks) + 1) * nf
        self.RRDB = RRDBNet(in_nc, out_nc, nf, nb, gc, scale)
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
                               self.cond_keys(), kernels, conv)

    def _conds(self, lr_enc):
        names = LEVEL_NAMES[self.scale]
        return {lvl: lr_enc[names[lvl]] for lvl in range(1, self.L + 1)}

    def precompute_ft(self, lr_enc):
        return self.flowUpsamplerNet.precompute_ft(self._conds(lr_enc))

    @torch.no_grad()
    def prime_actnorms(self, gt, lr):
        """Data-dependent actnorm init from one (gt (B, H, W, 3), lr (B,
        H/4, W/4, 3)) batch, as ``bfsr_tpu/models/srflow/srflow_net.py:
        prime_actnorms`` (the reference's ``FlowActNorms.py:45-59``), then
        ``freeze()`` again, the same ``step_form``.  Only meaningful on a
        random flow (``flowUpsamplerNet.actnorms_unprimed()``)."""
        conds = self._conds(self.rrdb_preprocess(lr))
        self.flowUpsamplerNet.prime_actnorms(gt, conds)
        steps = self.flowUpsamplerNet.steps()
        return self.freeze(steps[0].step_form if steps else "xla")

    def normal_flow(self, gt, cache, kernels=True):
        """Encode gt (B, H, W, 3) -> [eps0, z_final], no noise, no log-det."""
        return self.flowUpsamplerNet.encode(gt, cache, kernels)

    def reverse_flow(self, epses, cache, kernels=True, differentiable=False):
        """Decode [eps0, z_final] -> the SR images (B, H, W, 3)."""
        return self.flowUpsamplerNet.decode(epses, cache, kernels,
                                            differentiable)

    def sample_z(self, heat, lr_hw, generator=None, device=None):
        """The final latent (1, s*h/2^L, s*w/2^L, final_c): zeros at heat
        0, else N(0, heat^2) drawn from ``generator``."""
        h = self.scale * lr_hw[0] // 2 ** self.L
        w = self.scale * lr_hw[1] // 2 ** self.L
        shape = (1, h, w, self.final_c)
        if not heat:
            return torch.zeros(shape, device=device)
        return torch.randn(shape, generator=generator, device=device) * heat
