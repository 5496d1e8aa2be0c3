"""FlowUpsamplerNet: SRFlow's Glow pyramid as a static layer plan, eval.

The counterpart of ``bfsr_tpu/models/srflow/flow_upsampler.py`` in its
NHWC form (no space-to-depth level 1).  ``build_plan`` is the same plan:
for scale 4, L=3, K=16, two unconditional steps per level and the split
at level 1,

  level 1: squeeze(3->12)   2x[actnorm,invconv]  16x[actnorm,invconv,affine]
           split (12 -> pass 6, eps 6)
  level 2: squeeze(6->24)   2x[...]              16x[...]
  level 3: squeeze(24->96)  2x[...]              16x[...]

``layers`` holds one module per plan entry, so the ``state_dict`` keys are
the reference's ``layers.{i}.{actnorm,invconv,affine.fFeatures.{0,2,4},
affine.fAffine.{0,2,4}}`` and ``layers.{i}.conv`` (the split).

``freeze(step_form="xla")`` does what ``cache_flow_inverses`` does (the
folded actnorm + invconv of every step, inverse in float64) and packs each
conditional step's weights for K5: ``kpacked`` (f32, ``pack_step``) and
``kpacked_bf16`` (the bf16 buffer of the one-pass form ``step_form``
serves under ``default``, ``pack_step_bf16``: ``"xla"``, the JAX
predictor's numerics, or ``"pallas"``, the JAX FlowStep kernel's; see
``ops/cuda/flow_step.py``); call it again after changing the weights.
``encode`` / ``decode`` run every conditional step through K5
(``flow_step_forward`` / ``_reverse``, in the form of the stage's
precision: the kernel for a CUDA tensor, its twin for a CPU one) with
``kernels=True``, and through the unfused ``an_invconv_fused`` (f32 in
every mode, as the JAX package's XLA step) + ``cond_affine`` (its convs
through ``fnn.conv2d``) with ``kernels=False``; ``kernels=TWINS``
(``ops/cuda``) runs K5's plain twins, on any device.  All take a batch.
``decode(..., differentiable=True)`` is the decode that autograd
differentiates with respect to its epses (the prior trainer's image
loss): on the kernel path every conditional step through
``FlowStepReverse`` (K5's reverse, its twin's gradient); the unfused path
is differentiable as it is.

``decode(..., eps_std=, generator=)`` starts from the final latent alone
(``epses=[z]``) and draws each split's eps (``flows.split2d_logdet``):
heat sampling, whose steps still run on K5.

``encode_logdet`` / ``decode_logdet`` are the trainers' and the NLL's
passes (``bfsr_tpu``'s ``encode`` / ``decode`` with a log-det): every step
unfused on the module's live ``actnorm`` / ``invconv`` / ``affine`` weights
(``FlowStep.forward_logdet`` / ``reverse_logdet``), differentiable in
them, threading a per-image log-det; no kernel (the JAX package's kernel
drops the log-det and has no backward).  ``precompute_ft(conds,
differentiable=True)`` gives records autograd differentiates.

``freeze()`` stamps the steps' packs and folds (``ops/cuda``:
``stamp_layouts``); ``encode`` / ``decode`` raise if the weights changed
in place since (an optimizer's step), rather than read stale packs.

``actnorms_unprimed`` / ``prime_actnorms`` are the data-dependent actnorm
init of a random flow from its first training batch, as
``bfsr_tpu/models/srflow/flow_upsampler.py`` does it (the reference's
``FlowActNorms.py:45-59``).
"""

import math

import torch
from torch import nn

from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops.cuda import TWINS, check_layouts, stamp_layouts
from bfsr_tpu_torch.ops.cuda.flow_step import (flow_step_forward,
                                               flow_step_forward_twin,
                                               flow_step_reverse,
                                               flow_step_reverse_diff,
                                               flow_step_reverse_twin,
                                               pack_step, pack_step_bf16)

LEVEL_NAMES = {4: {0: "fea_up4", 1: "fea_up2", 2: "fea_up1", 3: "fea_up0",
                   4: "fea_up-1"}}


def build_plan(scale=4, L=3, K=16, additional_steps=2, split_enable=True,
               consume_ratio=0.5, base_c=3):
    """(plan, final_c); plan entries {'kind': 'squeeze' | 'step_nc' |
    'step_cond' | 'split', 'level', 'c'[, 'consume']}."""
    if isinstance(K, int):
        K = [K] * (L + 1)
    plan = []
    c, h = base_c, 160  # only log2 ratios of the reference's 160 matter
    for level in range(1, L + 1):
        c, h = c * 4, h // 2
        lvl = int(round(math.log2(160 / h)))
        plan.append({"kind": "squeeze", "level": lvl, "c": c})
        for _ in range(additional_steps):
            plan.append({"kind": "step_nc", "level": lvl, "c": c})
        for _ in range(K[level]):
            plan.append({"kind": "step_cond", "level": lvl, "c": c})
        if split_enable and level < L - 1:
            n_consume = int(round(c * consume_ratio))
            plan.append({"kind": "split", "level": lvl, "c": c,
                         "consume": n_consume})
            c -= n_consume
    return plan, c


class FlowStep(nn.Module):
    """actnorm -> invconv [-> conditional affine coupling]."""

    def __init__(self, c, c_cond=None, hidden=64):
        super().__init__()
        self.actnorm = flows.ActNorm(c)
        self.invconv = flows.InvConv1x1(c)
        self.affine = (flows.CondAffine(c, c_cond, hidden)
                       if c_cond is not None else None)
        self.hidden = hidden
        self.fold = None     # fold_actnorm_invconv, by freeze()
        self.step_form = "xla"   # the one-pass form of kpacked_bf16
        self.register_buffer("kpacked", None, persistent=False)
        self.register_buffer("kpacked_bf16", None, persistent=False)

    @torch.no_grad()
    def freeze(self, step_form="xla"):
        self.fold = flows.fold_actnorm_invconv(self.actnorm, self.invconv)
        if self.affine is not None:
            self.kpacked = pack_step(self.actnorm, self.invconv, self.affine)
            self.kpacked_bf16 = pack_step_bf16(self.actnorm, self.invconv,
                                               self.affine, step_form)
            self.step_form = step_form

    def forward_step(self, x, rec=None, kernels=True):
        if self.affine is not None and kernels:
            fwd = flow_step_forward_twin if kernels == TWINS else \
                flow_step_forward
            return fwd(x, rec, self.kpacked, self.hidden, self.kpacked_bf16,
                       self.step_form)
        x = flows.an_invconv_fused(x, self.fold)
        if self.affine is not None:
            x = flows.cond_affine(x, rec, self.affine)
        return x

    def reverse_step(self, x, rec=None, kernels=True, differentiable=False):
        if self.affine is not None and kernels:
            if kernels == TWINS:
                rev = flow_step_reverse_twin
            else:
                rev = (flow_step_reverse_diff if differentiable
                       else flow_step_reverse)
            return rev(x, rec, self.kpacked, self.hidden, self.kpacked_bf16,
                       self.step_form)
        if self.affine is not None:
            x = flows.cond_affine(x, rec, self.affine, reverse=True)
        return flows.an_invconv_fused(x, self.fold, reverse=True)

    def forward_logdet(self, x, rec, logdet):
        """The unfused step on the live weights, and its log-det."""
        x, logdet = flows.actnorm_logdet(x, self.actnorm, logdet)
        x, logdet = flows.invconv1x1(x, self.invconv, logdet)
        if self.affine is not None:
            x, logdet = flows.cond_affine_logdet(x, rec, self.affine, logdet)
        return x, logdet

    def reverse_logdet(self, x, rec, logdet):
        if self.affine is not None:
            x, logdet = flows.cond_affine_logdet(x, rec, self.affine, logdet,
                                                 reverse=True)
        x, logdet = flows.invconv1x1(x, self.invconv, logdet, reverse=True)
        return flows.actnorm_logdet(x, self.actnorm, logdet, reverse=True)


class FlowUpsamplerNet(nn.Module):
    def __init__(self, plan, cond_channels=320, hidden=64):
        super().__init__()
        self.plan = plan
        layers = []
        for e in plan:
            if e["kind"] == "squeeze":
                layers.append(nn.Identity())
            elif e["kind"] == "step_nc":
                layers.append(FlowStep(e["c"]))
            elif e["kind"] == "step_cond":
                layers.append(FlowStep(e["c"], cond_channels, hidden))
            else:
                layers.append(flows.Split2d(e["c"]))
        self.layers = nn.ModuleList(layers)

    def steps(self):
        return [m for m in self.layers if isinstance(m, FlowStep)]

    @torch.no_grad()
    def freeze(self, step_form="xla"):
        for m in self.steps():
            m.freeze(step_form)
        stamp_layouts(self)
        return self

    def frozen(self):
        return all(m.fold is not None for m in self.steps())

    def actnorms_unprimed(self):
        """True if every step's actnorm still holds its all-zero init (no
        priming, no training, no loaded checkpoint)."""
        return all(not (m.actnorm.bias.any() or m.actnorm.logs.any())
                   for m in self.steps())

    @torch.no_grad()
    def prime_actnorms(self, gt, conds):
        """Set each step's actnorm to whiten the activation that reaches
        it, in one unfused encode of ``gt`` (B, H, W, 3) whose steps apply
        each actnorm as soon as it is set.  conds: as for
        ``precompute_ft``.  The folds and K5 buffers are stale after
        it: call ``freeze()``."""
        cache = self.precompute_ft(conds)
        x = gt
        for e, m, rec in zip(self.plan, self.layers, cache):
            kind = e["kind"]
            if kind == "squeeze":
                x = flows.squeeze2d(x)
            elif kind == "split":
                x, _ = flows.split2d(x, m)
            else:
                bias, logs = flows.actnorm_init_stats(x)
                m.actnorm.bias.copy_(bias.reshape(m.actnorm.bias.shape))
                m.actnorm.logs.copy_(logs.reshape(m.actnorm.logs.shape))
                x = flows.invconv1x1(flows.actnorm(x, m.actnorm), m.invconv,
                                     None)[0]
                if m.affine is not None:
                    x = flows.cond_affine(x, rec, m.affine)

    def precompute_ft(self, conds, differentiable=False):
        """Per-step conditioning records (``flows.cond_affine_cache_batched``),
        one batched pass per level; a list aligned with the plan (None for
        entries without one).  conds: {level: (B, h, w, C_cond)}.
        ``differentiable``: records that autograd differentiates (the
        trainers'); by default computed without a graph."""
        by_level = {}
        for i, e in enumerate(self.plan):
            if e["kind"] == "step_cond":
                by_level.setdefault(e["level"], []).append(i)
        out = [None] * len(self.plan)
        for lvl, idxs in by_level.items():
            recs = flows.cond_affine_cache_batched(
                conds[lvl], [self.layers[i].affine for i in idxs],
                differentiable)
            for i, r in zip(idxs, recs):
                out[i] = r
        return out

    def _encode(self, x, cache, step, logdet=None):
        epses = []
        for e, m, rec in zip(self.plan, self.layers, cache):
            kind = e["kind"]
            if kind == "squeeze":
                x = flows.squeeze2d(x)
            elif kind == "split":
                x, logdet, eps = flows.split2d_logdet(x, m, logdet)
                epses.append(eps)
            else:
                x, logdet = step(m, x, rec, logdet)
        return epses + [x], logdet

    def _decode(self, epses, cache, step, logdet=None, eps_std=None,
                generator=None):
        epses = list(epses)
        x = epses.pop()
        for e, m, rec in zip(reversed(self.plan), reversed(self.layers),
                             reversed(cache)):
            kind = e["kind"]
            if kind == "squeeze":
                x = flows.unsqueeze2d(x)
            elif kind == "split":
                x, logdet, _ = flows.split2d_logdet(
                    x, m, logdet, reverse=True,
                    eps=epses.pop() if epses else None, eps_std=eps_std,
                    generator=generator)
            else:
                x, logdet = step(m, x, rec, logdet)
        return x, logdet

    def encode(self, gt, cache, kernels=True):
        """gt (B, H, W, 3) -> [eps of each split..., z_final]."""
        check_layouts(self)
        return self._encode(gt, cache, lambda m, x, rec, ld: (
            m.forward_step(x, rec, kernels), ld))[0]

    def decode(self, epses, cache, kernels=True, differentiable=False,
               eps_std=None, generator=None):
        """The inverse: epses back to front, z_final first.  Given
        ``[z_final]`` alone, each split's eps is drawn from ``generator``
        times ``eps_std`` (zeros with no generator: heat 0)."""
        check_layouts(self)
        return self._decode(epses, cache, lambda m, x, rec, ld: (
            m.reverse_step(x, rec, kernels, differentiable), ld),
            eps_std=eps_std, generator=generator)[0]

    def encode_logdet(self, gt, cache, logdet):
        """(epses, logdet): the encode unfused on the live weights, with
        its log-det added to ``logdet`` ((B,) f32); ``cache`` from
        ``precompute_ft``."""
        return self._encode(gt, cache, lambda m, x, rec, ld:
                            m.forward_logdet(x, rec, ld), logdet)

    def decode_logdet(self, epses, cache, logdet):
        """(x, logdet): ``decode`` unfused on the live weights, its
        log-det added to ``logdet`` (None: not computed); given ``[z]``
        alone, each split's eps is zero (heat 0)."""
        return self._decode(epses, cache, lambda m, x, rec, ld:
                            m.reverse_logdet(x, rec, ld), logdet)
