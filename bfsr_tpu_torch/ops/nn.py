"""Functional NN primitives on NHWC tensors, torch-layout weights.

The counterpart of ``bfsr_tpu/ops/nn.py``.  Conventions:

* activations are NHWC, as at every public function of the JAX package;
* conv weights are torch's OIHW ``(cout, cin, kh, kw)`` and linears
  ``(out, in)`` — the layout the modules' ``state_dict`` s carry, so a
  reference checkpoint loads as it is;
* batch norm is the eval form over running statistics, or, for the
  trainer, the batch-statistics form, which also returns the batch's
  statistics for the running-stat update.  Inside ``data_parallel(group,
  index, count)`` (a data-parallel step's trainable part) the statistics
  are the global batch's, over ``group``, as GSPMD computes them for the
  JAX step, and ``global_rows`` gives a per-sample random draw's rows of
  the global batch (``swinir.drop_path``).  Inside ``width_sharded(group,
  index, count)`` (one image's width split over the ranks; ``ops/halo.py``)
  a SAME conv wider than 1x1 exchanges halos with the neighbouring strips
  and the pool refuses a strip it would pair across its edge.

Precision modes, as ``bfsr_tpu/ops/nn.py`` defines them (a TPU computes
them so):

* ``high`` (the default) and ``highest``: true float32.  cuDNN convs
  default to TF32 in torch; importing this module turns TF32 off for both
  cuDNN and cuBLAS, so every plain op computes in f32.
* ``default`` (bf16 serving): every conv and linear that reads the mode
  takes its operands rounded to bf16 (round to nearest even) and
  accumulates the products in f32; its output and bias stay f32.  Its
  gradient is what XLA's transposed ops at ``Precision.DEFAULT`` compute
  (``bfsr_tpu/pipelines/linf_train.py``: the backward inherits the
  precision): each backward product takes bf16-rounded operands, the
  incoming gradient among them, and sums in f32, unrounded; the bias's
  gradient is the f32 sum of the unrounded incoming gradient.
* ``mixed``: per stage, by ``MIXED_POLICY`` (the prior in bf16, every
  other stage f32).  Pipelines name their stages with ``stage(name)``.

The mode comes from ``BFSR_PRECISION`` at import, or from
``set_default_precision``, and is read at each call: a frozen model
serves every mode.  The flows, K2 and K6 read no mode and stay f32.  The
JAX package's 2-pass sentinels (``two_pass``, ``two_pass_act``) were
refuted on the TPU and are not ported: a policy naming them raises.
"""

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bfsr_tpu_torch.ops import halo
# the width-sharded scope lives with the exchange it drives
from bfsr_tpu_torch.ops.halo import width_shard, width_sharded  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

PRECISIONS = ("default", "high", "highest")
MODES = PRECISIONS + ("mixed",)
# the stages BFSR_PRECISION=mixed runs in bf16 (the JAX package's policy)
MIXED_POLICY = {"prior": "default"}
_UNPORTED = ("two_pass", "two_pass_act")


def _parse_mode(mode):
    if mode not in MODES:
        raise ValueError(f"BFSR_PRECISION={mode!r}: expected one of "
                         f"{sorted(MODES)}")
    return mode


_MODE = _parse_mode(os.environ.get("BFSR_PRECISION", "high"))
_STAGE = None
# (dp group, this rank's index, dp size) inside ``data_parallel``
_DP = None


def set_default_precision(mode):
    """mode: 'default' | 'high' | 'highest' | 'mixed'."""
    global _MODE
    _MODE = _parse_mode(mode)


def precision_mode():
    """The mode as set: 'default' | 'high' | 'highest' | 'mixed'."""
    return _MODE


def stage_precision():
    """The precision of the current stage: 'default' | 'high' |
    'highest'."""
    if _MODE != "mixed":
        return _MODE
    p = MIXED_POLICY.get(_STAGE, "high")
    if p in _UNPORTED:
        raise NotImplementedError(
            f"MIXED_POLICY[{_STAGE!r}] = {p!r}: the 2-pass bf16 sentinels "
            "are not ported (refuted on the TPU, BENCH_NOTES.md)")
    if p not in PRECISIONS:
        raise ValueError(f"MIXED_POLICY[{_STAGE!r}] = {p!r}: expected one "
                         f"of {PRECISIONS}")
    return p


# the JAX package's name for the same thing at its raw einsum call sites;
# without the 2-pass sentinels the two agree
default_precision = stage_precision


def bf16_stage():
    """True where convs and linears take bf16 operands."""
    return stage_precision() == "default"


class stage:
    """``with stage(name):`` scopes a pipeline stage for the ``mixed``
    policy; the enclosing stage comes back on exit, also on an
    exception."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _STAGE
        self.saved = _STAGE
        _STAGE = self.name
        return self

    def __exit__(self, *exc):
        global _STAGE
        _STAGE = self.saved
        return False


def round_bf16(t):
    """Round to the nearest bf16 (ties to even), kept in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


class _RoundBf16(torch.autograd.Function):
    """``round_bf16`` whose backward passes the gradient straight
    through."""

    @staticmethod
    def forward(ctx, t):
        return round_bf16(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16Grad(torch.autograd.Function):
    """The identity on the output y of a product whose bias was added
    detached: the backward rounds the gradient that flows into the
    product to bf16 and gives the bias the sum of the unrounded gradient
    over ``dims`` (XLA's bias add is not a dot)."""

    @staticmethod
    def forward(ctx, y, bias, dims):
        ctx.dims, ctx.has_bias = dims, bias is not None
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (round_bf16(g), g.sum(ctx.dims) if ctx.has_bias else None,
                None)


def _bf16_product(op, x, weight, bias, dims):
    """``op(x, weight, bias)`` in a bf16 stage (the module docstring):
    dx = op^T(round(g), round(w)), dw = op_w(round(x), round(g)) in f32,
    db = the sum of g; the forward is bit for bit ``op`` on the rounded
    operands."""
    y = op(_RoundBf16.apply(x), _RoundBf16.apply(weight),
           None if bias is None else bias.detach())
    return _Bf16Grad.apply(y, bias, dims)


def conv2d_nchw(x, weight, bias=None, stride=1, padding=0):
    """``F.conv2d`` on NCHW that follows the stage's precision, forward
    and backward (the module docstring)."""
    def op(x, w, b):
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    if bf16_stage():
        return _bf16_product(op, x, weight, bias, (0, 2, 3))
    return op(x, weight, bias)


def conv2d(x, weight, bias=None, stride=1, padding=None):
    """x: (B, H, W, Cin); weight: (Cout, Cin, kh, kw).  ``padding=None`` is
    SAME for odd kernels at stride 1.  Follows the stage's precision.
    Inside ``width_sharded`` a SAME conv wider than 1x1 runs on the strip
    with its neighbours' kw // 2 columns and crops them."""
    r = weight.shape[-1] // 2
    if padding is None:
        padding = r
    if r and width_shard():
        if stride != 1 or padding != r:
            raise NotImplementedError(
                "under width_sharded a conv wider than 1x1 must be SAME at "
                f"stride 1; got stride {stride}, padding {padding}")
        return halo.apply(lambda h: conv2d(h, weight, bias), r, [x])
    return nchw_to_nhwc(conv2d_nchw(nhwc_to_nchw(x), weight, bias, stride,
                                    padding))


def linear(x, weight, bias=None):
    """x @ weight.T + bias; weight (out, in).  Follows the stage's
    precision, forward and backward."""
    if bf16_stage():
        return _bf16_product(F.linear, x, weight, bias,
                             tuple(range(x.dim() - 1)))
    return F.linear(x, weight, bias)


def matmul(a, b):
    """``a @ b`` (batched) that follows the stage's precision, forward and
    backward: the raw ``jnp.einsum(..., precision=default_precision())``
    sites of the JAX package (the Swin attention's two products)."""
    if bf16_stage():
        return _bf16_product(lambda x, y, _: torch.matmul(x, y), a, b, None,
                             ())
    return torch.matmul(a, b)


def layer_norm(x, ln, eps=1e-5):
    """LayerNorm over the last axis: ``ln``, an ``nn.LayerNorm`` (its
    affine); the JAX package's ``swinir.layer_norm`` (biased variance)."""
    return F.layer_norm(x, x.shape[-1:], ln.weight, ln.bias, eps)


def pixel_shuffle(x, r):
    """NHWC pixel shuffle: (B, H, W, C r^2) -> (B, H r, W r, C), channels
    read in torch ``nn.PixelShuffle``'s (c, ry, rx) order."""
    return nchw_to_nhwc(F.pixel_shuffle(nhwc_to_nchw(x), r))


def relu(x):
    return torch.relu(x)


def leaky_relu(x, negative_slope=0.2):
    return F.leaky_relu(x, negative_slope)


def max_pool2d(x, window=2):
    """NHWC max pool, stride = window, VALID.  Inside ``width_sharded``
    it is local, and a strip whose width the window does not divide
    raises."""
    if width_shard() and x.shape[2] % window:
        raise ValueError(f"width_sharded: a strip of width {x.shape[2]} does "
                         f"not pool by {window} on its own")
    return nchw_to_nhwc(F.max_pool2d(nhwc_to_nchw(x), window))


class data_parallel:
    """``with data_parallel(group, index, count):`` scopes the trainable
    part of a data-parallel step: this rank holds batch shard ``index`` of
    ``count`` (equal shards) and ``group`` is the dp group.  BatchNorm then
    takes the global batch's statistics over ``group``, and a per-sample
    draw (``global_rows``) is drawn for the global batch and sliced.  The
    enclosing scope comes back on exit, also on an exception."""

    def __init__(self, group, index, count):
        self.dp = (group, index, count)

    def __enter__(self):
        global _DP
        self.saved, _DP = _DP, self.dp
        return self

    def __exit__(self, *exc):
        global _DP
        _DP = self.saved
        return False


def global_rows(draw, n):
    """``draw(n)`` for this rank's ``n`` samples: inside
    ``data_parallel`` ``draw(n * count)`` (every rank draws the global
    batch from the same generator state) sliced to this rank's shard,
    else ``draw(n)``."""
    if _DP is None:
        return draw(n)
    _, index, count = _DP
    return draw(n * count)[index * n:(index + 1) * n]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """The sum of ``x`` over ``group``, on every rank; its gradient is the
    sum over ranks of the gradients of ``x``'s uses (the all-reduce's
    adjoint), so that each rank's backward sees every rank's loss."""
    return _AllReduceSum.apply(x, group)


def _global_stats(x, group):
    """(mean, biased var, unbiased var) over (B, H, W) of the global batch:
    two-pass, as the single-process form (and GSPMD's global reduction)
    computes them; each pass one all-reduce of partial sums, which autograd
    differentiates."""
    n_local = x.shape[0] * x.shape[1] * x.shape[2]
    s = all_reduce_sum(torch.cat([x.sum(dim=(0, 1, 2)),
                                  x.new_full((1,), float(n_local))]), group)
    n = s[-1]
    mean = s[:-1] / n
    var = all_reduce_sum(((x - mean) ** 2).sum(dim=(0, 1, 2)), group) / n
    return mean, var, var * (n / torch.clamp(n - 1, min=1))


def batch_norm(x, bn, training=False, eps=1e-5):
    """BatchNorm over the last (channel) axis of an NHWC tensor.  ``bn``:
    an ``nn.BatchNorm2d`` (its running stats and affine).  Eval mode
    normalises with the running stats.  ``training=True`` normalises with
    the batch's mean and biased variance over (B, H, W) and returns
    ``(y, (mean, unbiased var))``: torch folds the unbiased (n / (n - 1))
    variance into ``running_var``, as ``bfsr_tpu/ops/nn.py:batch_norm``
    returns it for ``apply_bn_updates``.  Inside ``data_parallel`` the
    batch is the global one (``_global_stats``; ``nn.SyncBatchNorm`` takes
    CUDA inputs only)."""
    if not training:
        return ((x - bn.running_mean) * torch.rsqrt(bn.running_var + eps)
                * bn.weight + bn.bias)
    if _DP is not None:
        mean, var, unbiased = _global_stats(x, _DP[0])
    else:
        mean = x.mean(dim=(0, 1, 2))
        var = ((x - mean) ** 2).mean(dim=(0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = var * (n / max(n - 1, 1))
    y = (x - mean) * torch.rsqrt(var + eps) * bn.weight + bn.bias
    return y, (mean, unbiased)


def fold_bn(bn, conv_bias=None, eps=1e-5):
    """Fold eval BatchNorm (after a conv with optional bias) into a
    per-channel (scale, bias):
    (conv(x) + b - mean) * g / sqrt(var + eps) + beta
    = conv(x) * s + ((b - mean) * s + beta).
    The counterpart of ``bfsr_tpu/ops/pallas/conv3x3.py:fold_bn``."""
    s = bn.weight / torch.sqrt(bn.running_var + eps)
    base = -bn.running_mean if conv_bias is None else conv_bias - bn.running_mean
    return s, base * s + bn.bias


# ---------------------------------------------------------------------------
# initializers — the distributions of bfsr_tpu/ops/nn.py (torch defaults),
# drawn from an explicit torch.Generator
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_conv_(conv, generator, mode="torch", gain=1.0):
    """Initialise an ``nn.Conv2d`` (OIHW) in place.

    mode='torch' — U(+-1/sqrt(fan_in)) weight and bias, torch's Conv2d
    default; 'kaiming_normal_fan_in' — N(0, 2/fan_in) * gain weight, zero
    bias (the UNet's DenseBlock_5C); 'xavier_normal' — N(0, 2/(fan_in +
    fan_out)) * gain weight, zero bias (the RRDB dense blocks).
    """
    fan_in = conv.weight[0].numel()
    fan_out = conv.weight.shape[0] * conv.weight[0, 0].numel()
    if mode == "torch":
        bound = 1.0 / fan_in ** 0.5
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)
        return
    if mode == "kaiming_normal_fan_in":
        std = (2.0 / fan_in) ** 0.5 * gain
    elif mode == "xavier_normal":
        std = (2.0 / (fan_in + fan_out)) ** 0.5 * gain
    else:
        raise ValueError(mode)
    conv.weight.normal_(0.0, std, generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()


@torch.no_grad()
def init_linear_(lin, generator):
    """U(+-1/sqrt(fan_in)) weight and bias, torch's Linear default."""
    bound = 1.0 / lin.weight.shape[1] ** 0.5
    lin.weight.uniform_(-bound, bound, generator=generator)
    if lin.bias is not None:
        lin.bias.uniform_(-bound, bound, generator=generator)
