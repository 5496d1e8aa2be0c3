"""Glow-style flow primitives of SRFlow, NHWC.

The counterpart of ``bfsr_tpu/ops/flows.py``.  Modules hold the weights
under the reference's ``state_dict`` names and shapes (``ActNorm2d``
bias/logs ``(1, C, 1, 1)``, the invertible 1x1 conv's ``(C, C)`` weight,
``Conv2dZeros`` logs ``(C, 1, 1)``); the functions take those modules and
NHWC tensors.

* ``squeeze2d`` keeps torch's ``(C, fy, fx)`` channel nesting in NHWC.
* ``split_feature(h, 'cross')`` is ``shift = h[..., 0::2]``,
  ``scale = h[..., 1::2]``.
* Frozen eval solves no inverse at run time: ``fold_actnorm_invconv``
  folds an actnorm and its 1x1 conv into one affine per direction, in
  float64 on the host, with the inverse taken in float64.
* The conditioning caches of one flow level (``cond_affine_cache_batched``)
  are per-step records ``(B, h, w, 2C + hidden)``, laid out per pixel as
  ``[scale_ft | shift_ft | aff1_ft]``: what the coupling reads that
  depends on the RRDB conditioning only, computed once per batch and read
  by every encode and decode step (and by the K5 kernel as it is).

Training and the NLL take the ``*_logdet`` forms, which run on the live
weights under autograd and thread a per-image ``(B,)`` f32 log-det as the
JAX functions do (``logdet=None`` skips it): ``actnorm_logdet``,
``invconv1x1`` (forward ``x @ W^T``, reverse through ``torch.linalg.inv``,
log-det ``slogdet(W)[1] * pixels``), ``cond_affine_logdet`` (with the
record's conditioning-only ``sum log scale_ft``) and ``split2d_logdet``
(the consumed half's Gaussian log-likelihood; in reverse its eps drawn
from a ``torch.Generator`` times ``eps_std``, or zeros at heat 0 with no
generator).  Every log-det sum is taken in f32.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from bfsr_tpu_torch.ops import nn as fnn

AFFINE_EPS = 1e-4
LOG2PI = math.log(2 * math.pi)


def _pixels(x):
    return x.shape[1] * x.shape[2]


def _sum_log(scale):
    return torch.log(scale).float().sum((1, 2, 3))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class ActNorm(nn.Module):
    """y = (x + bias) * exp(logs), per channel."""

    def __init__(self, c):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.logs = nn.Parameter(torch.zeros(1, c, 1, 1))

    def vectors(self):
        return self.bias.reshape(-1), self.logs.reshape(-1)


class InvConv1x1(nn.Module):
    """Invertible 1x1 conv: y = x @ weight^T, weight (out, in)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(c))


class FlowConv(nn.Module):
    """Conv (no bias) + its own actnorm (the reference's flow ``Conv2d``)."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.actnorm = ActNorm(cout)


class FlowConvZeros(nn.Module):
    """Zero-initialised conv, output scaled by exp(3 * logs)."""

    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.logs = nn.Parameter(torch.zeros(cout, 1, 1))


def flow_tower(cin, cout, hidden):
    """The coupling's F(): conv3x3+an -> relu -> conv1x1+an -> relu ->
    conv3x3-zeros, at the reference's Sequential indices 0, 2, 4."""
    return nn.Sequential(FlowConv(cin, hidden, 3), nn.ReLU(),
                         FlowConv(hidden, hidden, 1), nn.ReLU(),
                         FlowConvZeros(hidden, cout, 3))


class CondAffine(nn.Module):
    """``CondAffineSeparatedAndCond``: a feature-conditional affine
    (``fFeatures``: conditioning -> 2C) and a coupling on the second half
    (``fAffine``: [z1, conditioning] -> 2 * (C - C//2))."""

    def __init__(self, c, c_cond, hidden):
        super().__init__()
        cn = c // 2
        self.fFeatures = flow_tower(c_cond, 2 * c, hidden)
        self.fAffine = flow_tower(cn + c_cond, 2 * (c - cn), hidden)


class Split2d(nn.Module):
    """Split with a learned prior on the consumed half."""

    def __init__(self, c, consume_ratio=0.5):
        super().__init__()
        n_consume = int(round(c * consume_ratio))
        self.conv = FlowConvZeros(c - n_consume, 2 * n_consume, 3)


# ---------------------------------------------------------------------------
# actnorm + invconv
# ---------------------------------------------------------------------------


def actnorm(x, an, reverse=False):
    bias, logs = an.vectors()
    if not reverse:
        return (x + bias) * torch.exp(logs)
    return x * torch.exp(-logs) - bias


def actnorm_logdet(x, an, logdet, reverse=False):
    """``actnorm`` and its log-det, ``sum(logs) * pixels`` (negated in
    reverse)."""
    y = actnorm(x, an, reverse)
    if logdet is not None:
        d = an.logs.float().sum() * _pixels(x)
        logdet = logdet - d if reverse else logdet + d
    return y, logdet


def actnorm_init_stats(x):
    """(bias, logs) vectors that whiten ``x`` per channel (the reference's
    data-dependent init)."""
    mean = x.mean((0, 1, 2))
    var = ((x - mean) ** 2).mean((0, 1, 2))
    return -mean, -torch.log(torch.sqrt(var) + 1e-6)


def invconv1x1(x, invconv, logdet, reverse=False):
    """The invertible 1x1 conv on its live weight: forward ``x @ W^T``,
    reverse ``x @ inv(W)^T``; log-det ``log|det W| * pixels`` (negated in
    reverse).  Differentiable in W."""
    w = invconv.weight
    if not reverse:
        y = x @ w.T
    else:
        y = x @ torch.linalg.inv_ex(w)[0].T
    if logdet is not None:
        d = torch.linalg.slogdet(w)[1] * _pixels(x)
        logdet = logdet - d if reverse else logdet + d
    return y, logdet


@torch.no_grad()
def fold_actnorm_invconv(an, invconv):
    """One affine per direction for an actnorm -> invconv pair, computed
    in float64 on the host (``flows.fold_actnorm_invconv``):

      fwd:  y = ((x + b) * e) @ W^T  = x @ W_fold^T + b_fold
      rev:  x = (y @ W^-T) / e - b   = y @ Winv_fold^T - an_bias

    with e = exp(logs) and W^-1 taken in float64.  Returns float32 tensors
    on the weights' device."""
    dev = invconv.weight.device
    bias, logs = (t.detach().double().cpu() for t in an.vectors())
    w = invconv.weight.detach().double().cpu()
    e = torch.exp(logs)
    w_fold = w * e[None, :]
    w_inv = torch.linalg.inv(w)
    out = {"w_fold": w_fold, "b_fold": w_fold @ bias,
           "w_inv_fold": w_inv / e[:, None], "an_bias": bias}
    return {k: v.float().to(dev) for k, v in out.items()}


def an_invconv_fused(x, fold, reverse=False):
    """Apply a folded actnorm + invconv pair."""
    if not reverse:
        return x @ fold["w_fold"].T + fold["b_fold"]
    return x @ fold["w_inv_fold"].T - fold["an_bias"]


# ---------------------------------------------------------------------------
# squeeze / split
# ---------------------------------------------------------------------------


def squeeze2d(x, factor=2):
    B, H, W, C = x.shape
    x = x.reshape(B, H // factor, factor, W // factor, factor, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # B, H/f, W/f, C, fy, fx
    return x.reshape(B, H // factor, W // factor, C * factor * factor)


def unsqueeze2d(x, factor=2):
    B, H, W, C = x.shape
    f2 = factor * factor
    x = x.reshape(B, H, W, C // f2, factor, factor)
    x = x.permute(0, 1, 4, 2, 5, 3)  # B, H, fy, W, fx, C/f2
    return x.reshape(B, H * factor, W * factor, C // f2)


def gaussian_likelihood(x, mean=None, logs=None):
    if mean is None and logs is None:
        return -0.5 * (x ** 2 + LOG2PI)
    return -0.5 * (logs * 2.0 + (x - mean) ** 2 * torch.exp(-2.0 * logs)
                   + LOG2PI)


def gaussian_logp(x, mean=None, logs=None):
    """The log-likelihood summed over all but the batch axis, in f32."""
    return gaussian_likelihood(x, mean, logs).float().sum(
        tuple(range(1, x.ndim)))


def gaussian_sample(mean, logs, eps_std=1.0, generator=None):
    eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                      dtype=mean.dtype) * eps_std
    return mean + torch.exp(logs) * eps


def split_feature(h, kind="split"):
    c = h.shape[-1]
    if kind == "split":
        return h[..., : c // 2], h[..., c // 2:]
    if kind == "cross":
        return h[..., 0::2], h[..., 1::2]
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the coupling tower
# ---------------------------------------------------------------------------


def flow_conv(x, m):
    return actnorm(fnn.conv2d(x, m.weight), m.actnorm)


def flow_conv_zeros(x, m):
    return fnn.conv2d(x, m.weight, m.bias) * torch.exp(m.logs.reshape(-1) * 3.0)


def flow_f(x, tower):
    h = torch.relu(flow_conv(x, tower[0]))
    h = torch.relu(flow_conv(h, tower[2]))
    return flow_conv_zeros(h, tower[4])


def flow_f_split(z1, tower, aff1_ft):
    """``flow_f`` over the implicit concat [z1, ft], with the ft part of the
    first conv precomputed (``aff1_ft``)."""
    w = tower[0].weight
    y = fnn.conv2d(z1, w[:, : z1.shape[-1]]) + aff1_ft
    h = torch.relu(actnorm(y, tower[0].actnorm))
    h = torch.relu(flow_conv(h, tower[2]))
    return flow_conv_zeros(h, tower[4])


def _scale_shift(h):
    shift, scale = split_feature(h, "cross")
    return torch.sigmoid(scale + 2.0) + AFFINE_EPS, shift


def cond_affine_cache_batched(ft, affines, differentiable=False):
    """The conditioning records of ALL K steps of a level in one pass.

    ft: (B, h, w, C_cond) NHWC; affines: the level's ``CondAffine`` s.
    One 3x3 conv of ft against every step's fFeatures conv1 and the ft
    slice of its fAffine conv1 (2 * K * hidden outputs); the fFeatures
    tails batch over a step axis (the 1x1 as a step-batched matmul, the
    out convs as one grouped conv).  Returns a list of contiguous
    ``(B, h, w, 2C + hidden)`` records ``[scale_ft | shift_ft | aff1_ft]``.

    In a bf16 stage the three products take bf16-rounded operands, as the
    JAX package's reads the stage's precision at each of them (the convs
    and the 1x1 stay f32 library calls on the rounded values); elsewhere
    nothing is rounded.

    With ``differentiable=True`` autograd differentiates the records with
    respect to ft and the towers' weights (the trainers' records); by
    default they are computed under ``torch.no_grad()``.
    """
    if not differentiable:
        with torch.no_grad():
            return cond_affine_cache_batched(ft, affines, True)
    rnd = fnn.round_bf16 if fnn.bf16_stage() else (lambda t: t)
    n = len(affines)
    B, h, w, c_ft = ft.shape
    hid = affines[0].fFeatures[0].weight.shape[0]
    c2 = affines[0].fFeatures[4].weight.shape[0]          # 2C
    w1 = torch.cat([a.fFeatures[0].weight for a in affines]
                   + [a.fAffine[0].weight[:, -c_ft:] for a in affines], 0)
    # (B, 2n*hid, h, w)
    y = F.conv2d(rnd(fnn.nhwc_to_nchw(ft)), rnd(w1), padding=1)
    ff1 = y[:, : n * hid].reshape(B, n, hid, h, w)
    aff1 = y[:, n * hid:].reshape(B, n, hid, h, w)

    def stacked(get):
        return torch.stack([get(a).reshape(-1) for a in affines])[
            None, :, :, None, None]

    z = torch.relu((ff1 + stacked(lambda a: a.fFeatures[0].actnorm.bias))
                   * torch.exp(stacked(lambda a: a.fFeatures[0].actnorm.logs)))
    w2 = torch.stack([a.fFeatures[2].weight[:, :, 0, 0] for a in affines])
    z = torch.einsum("bnihw,noi->bnohw", rnd(z), rnd(w2))
    z = torch.relu((z + stacked(lambda a: a.fFeatures[2].actnorm.bias))
                   * torch.exp(stacked(lambda a: a.fFeatures[2].actnorm.logs)))
    wout = torch.cat([a.fFeatures[4].weight for a in affines], 0)
    o = F.conv2d(rnd(z.reshape(B, n * hid, h, w)), rnd(wout), padding=1,
                 groups=n)
    o = ((o.reshape(B, n, c2, h, w) + stacked(lambda a: a.fFeatures[4].bias))
         * torch.exp(3.0 * stacked(lambda a: a.fFeatures[4].logs)))
    shift, scale = o[:, :, 0::2], o[:, :, 1::2]
    scale = torch.sigmoid(scale + 2.0) + AFFINE_EPS
    rec = torch.cat([scale, shift, aff1], 2).permute(1, 0, 3, 4, 2)
    return [rec[s].contiguous() for s in range(n)]


def cond_affine_logdet(x, rec, affine, logdet, reverse=False):
    """The two-part conditional affine coupling, given the step's
    conditioning record ``rec`` (``cond_affine_cache_batched``), and its
    log-det: ``sum log scale_ft`` (the conditioning-only term, from the
    record) plus ``sum log scale`` of the coupling, negated in reverse."""
    c = x.shape[-1]
    cn = c // 2
    scale_ft, shift_ft = rec[..., :c], rec[..., c:2 * c]
    aff1_ft = rec[..., 2 * c:]
    sign = -1.0 if reverse else 1.0
    if logdet is not None:
        logdet = logdet + sign * _sum_log(scale_ft)
    if not reverse:
        z = (x + shift_ft) * scale_ft
        z1, z2 = z[..., :cn], z[..., cn:]
        scale, shift = _scale_shift(flow_f_split(z1, affine.fAffine, aff1_ft))
        z = torch.cat([z1, (z2 + shift) * scale], -1)
    else:
        z1, z2 = x[..., :cn], x[..., cn:]
        scale, shift = _scale_shift(flow_f_split(z1, affine.fAffine, aff1_ft))
        z = torch.cat([z1, z2 / scale - shift], -1) / scale_ft - shift_ft
    if logdet is not None:
        logdet = logdet + sign * _sum_log(scale)
    return z, logdet


def cond_affine(x, rec, affine, reverse=False):
    """``cond_affine_logdet`` without the log-det."""
    return cond_affine_logdet(x, rec, affine, None, reverse)[0]


def split2d_logdet(x, split, logdet, reverse=False, eps=None, eps_std=None,
                   generator=None):
    """Forward: (z1, logdet, eps) — the passed half, the log-det plus the
    consumed half's log-likelihood under the prior predicted from z1, and
    that half's eps.  Reverse: (state, logdet, None), the state rebuilt
    from z1 = x and ``eps``; without ``eps`` it is drawn from
    ``generator`` times ``eps_std`` (1 if None), or, with no generator,
    zeros (the heat-0 decode; ``eps_std`` must then be 0 or None)."""
    if not reverse:
        c = x.shape[-1]
        n_pass = c - int(round(c * 0.5))
        z1, z2 = x[..., :n_pass], x[..., n_pass:]
        mean, logs = split_feature(flow_conv_zeros(z1, split.conv), "cross")
        if logdet is not None:
            logdet = logdet + gaussian_logp(z2, mean, logs)
        return z1, logdet, (z2 - mean) / torch.exp(logs)
    mean, logs = split_feature(flow_conv_zeros(x, split.conv), "cross")
    if eps is None and generator is not None:
        z2 = gaussian_sample(mean, logs,
                             1.0 if eps_std is None else eps_std, generator)
    else:
        if eps is None:
            if eps_std:
                raise ValueError("split2d reverse with eps_std > 0 needs a "
                                 "generator (or explicit eps)")
            eps = torch.zeros_like(mean)
        z2 = mean + torch.exp(logs) * eps
    if logdet is not None:
        logdet = logdet - gaussian_logp(z2, mean, logs)
    return torch.cat([x, z2], -1), logdet, None


def split2d(x, split, reverse=False, eps=None):
    """Forward: (z1, eps) — the passed half and the consumed half's eps
    under the prior predicted from z1.  Reverse: the state rebuilt from
    z1 = x and ``eps`` (zeros when None: the heat-0 decode)."""
    if not reverse:
        z1, _, eps = split2d_logdet(x, split, None)
        return z1, eps
    return split2d_logdet(x, split, None, reverse=True, eps=eps)[0]
