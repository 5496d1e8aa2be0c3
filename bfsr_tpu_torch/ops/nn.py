"""Functional NN primitives on NHWC tensors, torch-layout weights.

The counterpart of ``bfsr_tpu/ops/nn.py``.  Conventions:

* activations are NHWC, as at every public function of the JAX package;
* conv weights are torch's OIHW ``(cout, cin, kh, kw)`` and linears
  ``(out, in)`` — the layout the modules' ``state_dict`` s carry, so a
  reference checkpoint loads as it is;
* batch norm is the eval form over running statistics, or, for the
  trainer, the batch-statistics form, which also returns the batch's
  statistics for the running-stat update.

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
import torch.nn.functional as F

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
    SAME for odd kernels at stride 1.  Follows the stage's precision."""
    if padding is None:
        padding = weight.shape[-1] // 2
    return nchw_to_nhwc(conv2d_nchw(nhwc_to_nchw(x), weight, bias, stride,
                                    padding))


def linear(x, weight, bias=None):
    """x @ weight.T + bias; weight (out, in).  Follows the stage's
    precision, forward and backward."""
    if bf16_stage():
        return _bf16_product(F.linear, x, weight, bias,
                             tuple(range(x.dim() - 1)))
    return F.linear(x, weight, bias)


def relu(x):
    return torch.relu(x)


def leaky_relu(x, negative_slope=0.2):
    return F.leaky_relu(x, negative_slope)


def max_pool2d(x, window=2):
    """NHWC max pool, stride = window, VALID."""
    return nchw_to_nhwc(F.max_pool2d(nhwc_to_nchw(x), window))


def batch_norm(x, bn, training=False, eps=1e-5):
    """BatchNorm over the last (channel) axis of an NHWC tensor.  ``bn``:
    an ``nn.BatchNorm2d`` (its running stats and affine).  Eval mode
    normalises with the running stats.  ``training=True`` normalises with
    the batch's mean and biased variance over (B, H, W) and returns
    ``(y, (mean, unbiased var))``: torch folds the unbiased (n / (n - 1))
    variance into ``running_var``, as ``bfsr_tpu/ops/nn.py:batch_norm``
    returns it for ``apply_bn_updates``."""
    if not training:
        return ((x - bn.running_mean) * torch.rsqrt(bn.running_var + eps)
                * bn.weight + bn.bias)
    mean = x.mean(dim=(0, 1, 2))
    var = ((x - mean) ** 2).mean(dim=(0, 1, 2))
    y = (x - mean) * torch.rsqrt(var + eps) * bn.weight + bn.bias
    n = x.shape[0] * x.shape[1] * x.shape[2]
    return y, (mean, var * (n / max(n - 1, 1)))


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
