"""K3: 3x3 SAME conv over an implicit channel concat, fused epilogue; and
K6, its single-input form.

Kernels: ``bfsr_tpu_torch/csrc/conv3x3.cu`` (f32) and
``bfsr_tpu_torch/csrc/conv3x3_bf16.cu`` (bf16 operands on tensor cores,
f32 accumulation), which replace ``bfsr_tpu/ops/pallas/s2d_conv.py:_kernel``
(``conv3x3_s2d``) at passes 3 and 1; ``conv3x3_fused`` replaces
``bfsr_tpu/ops/pallas/conv3x3.py:_kernel`` (K6) over the f32 kernel.

``y = act(conv3x3(concat(inputs, -1), weight) * scale + bias)`` with
inputs NHWC and weight torch OIHW over the concatenated input channels.
Both kernels take a batch (the trainer's encoder runs them at B = 16);
K6 takes batch 1.  The concat is never built on the
kernel path: each input keeps its own pointer and its own slice of the
weight, which the kernels read in the layouts of ``kernel_weight`` and
``kernel_weight_bf16`` (a frozen model keeps them as the conv's
``kweight`` and ``kweight_bf16`` buffers).

``conv3x3_cat`` follows the precision of the current stage
(``ops/nn.py``): bf16 operands where the stage is ``default``, f32
elsewhere.  A CPU tensor runs the plain twin of that precision; a CUDA
tensor launches that kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw

ACTS = {None: 0, "relu": 1, "lrelu": 2}
MAX_INPUTS = 5
KERNEL_COUTS = (8, 16, 32, 64)
# the grid's z extent: the images (f32), images x Cout blocks (bf16)
GRID_Z = 65535


def kernel_weight(weight):
    """OIHW weight -> the f32 kernel's (Cin, 3, 3, Cout) layout, in which
    each input's channels are one contiguous block."""
    return weight.detach().float().permute(1, 2, 3, 0).contiguous()


def kernel_weight_bf16(weight):
    """OIHW weight -> the bf16 kernel's (Cin, 3, 3, Cout_p) layout: the f32
    layout rounded to bf16, Cout zero-padded to a multiple of 16."""
    cout = weight.shape[0]
    w = kernel_weight(weight)
    w = F.pad(w, (0, -cout % 16))
    return w.to(torch.bfloat16).contiguous()


def k3_conv(cin, cout, bias=True):
    """A 3x3 SAME ``nn.Conv2d`` with non-persistent ``kweight`` and
    ``kweight_bf16`` buffers for the kernels' weight layouts: None until
    ``cache_kernel_weight``."""
    conv = nn.Conv2d(cin, cout, 3, padding=1, bias=bias)
    conv.register_buffer("kweight", None, persistent=False)
    conv.register_buffer("kweight_bf16", None, persistent=False)
    return conv


def cache_kernel_weight(conv):
    """Set a ``k3_conv``'s kernel layouts; call it again after changing the
    weight."""
    conv.kweight = kernel_weight(conv.weight)
    conv.kweight_bf16 = kernel_weight_bf16(conv.weight)


def conv3x3_cat_plain(inputs, weight, scale=None, bias=None, act=None,
                      slope=0.2):
    """Plain f32 twin: F.conv2d on the explicit concat, then the
    epilogue."""
    x = torch.cat(list(inputs), -1) if len(inputs) > 1 else inputs[0]
    y = nchw_to_nhwc(F.conv2d(nhwc_to_nchw(x), weight, padding=1))
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    if act == "relu":
        y = torch.relu(y)
    elif act == "lrelu":
        y = F.leaky_relu(y, slope)
    return y


def conv3x3_cat_bf16_plain(inputs, weight, scale=None, bias=None, act=None,
                           slope=0.2):
    """Plain bf16 twin: ``conv3x3_cat_plain`` on bf16-rounded inputs and
    weight, computed in f32 (exact products, f32 sums; the epilogue
    unrounded)."""
    return conv3x3_cat_plain([fnn.round_bf16(x) for x in inputs],
                             fnn.round_bf16(weight), scale, bias, act, slope)


def conv3x3_cat_twin(inputs, weight, scale=None, bias=None, act=None,
                     slope=0.2):
    """The plain twin of the current stage's precision."""
    plain = conv3x3_cat_bf16_plain if fnn.bf16_stage() else conv3x3_cat_plain
    return plain(list(inputs), weight, scale, bias, act, slope)


def _check(inputs, weight, act):
    if not 1 <= len(inputs) <= MAX_INPUTS:
        raise ValueError(f"conv3x3_cat takes 1-{MAX_INPUTS} inputs, got "
                         f"{len(inputs)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {list(ACTS)}, got {act!r}")
    B, H, W, _ = inputs[0].shape
    for x in inputs:
        if x.ndim != 4 or x.shape[:3] != (B, H, W):
            raise ValueError("inputs must be NHWC with one (B, H, W): "
                             f"{[tuple(t.shape) for t in inputs]}")
    cin = sum(x.shape[-1] for x in inputs)
    if weight.shape[1:] != (cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"(Cout, {cin}, 3, 3)")


def _require_cuda(x, name, max_batch=1):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.shape[0] > max_batch:
        raise ValueError(f"{name} takes B <= {max_batch}; got B={x.shape[0]}")


def _launch(entry, inputs, kweight, scale, bias, act, slope, cout,
            counter=None):
    """Launch C entry ``entry`` over ``inputs`` with the weight laid out as
    ``kweight`` (Cin, 3, 3, Cout or Cout_p): input i's block starts
    sum(cins[:i]) rows into it.  Both entries take the batch."""
    x0 = inputs[0]
    B, H, W, _ = x0.shape
    inputs = [x.contiguous() for x in inputs]
    scale, bias = (None if t is None else t.contiguous() for t in (scale, bias))
    out = torch.empty((B, H, W, cout), device=x0.device)
    cuda.check_cuda(entry, *inputs, *[t for t in (scale, bias) if t is not None],
                    out)
    if kweight.device != x0.device or not kweight.is_contiguous():
        raise ValueError(f"{entry}: the kernel weight must be contiguous on "
                         f"{x0.device}")
    n = len(inputs)
    cins = [x.shape[-1] for x in inputs]
    row = kweight.stride(0) * kweight.element_size()
    xs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in inputs])
    wp = (ctypes.c_void_p * n)(*[kweight.data_ptr() + sum(cins[:i]) * row
                                 for i in range(n)])
    cins = (ctypes.c_int * n)(*cins)
    cuda.launch(entry, n, xs, wp, cins, cuda.ptr(scale), cuda.ptr(bias),
                cuda.ptr(out), B, H, W, cout, ACTS[act], ctypes.c_float(slope),
                counter=counter)
    return out


def _check_kweight(kweight, weight, cout_p, dtype):
    want = (weight.shape[1], 3, 3, cout_p)
    if tuple(kweight.shape) != want or kweight.dtype != dtype:
        raise ValueError(f"kernel weight {tuple(kweight.shape)} "
                         f"{kweight.dtype} is not the {dtype} layout {want} "
                         f"of weight {tuple(weight.shape)} (re-run freeze()?)")


def conv3x3_cat_bf16(inputs, weight, scale=None, bias=None, act=None,
                     slope=0.2, kweight_bf16=None):
    """K3 with bf16 operands and f32 accumulation, in any stage: the bf16
    kernel on CUDA (any batch, Cout in 8/16/32/64 or a multiple of 64; the
    batch times the Cout blocks of 64 at most 65535), its twin
    ``conv3x3_cat_bf16_plain`` on CPU.  ``kweight_bf16``:
    ``kernel_weight_bf16(weight)`` if the caller keeps it."""
    inputs = list(inputs)
    _check(inputs, weight, act)
    if inputs[0].device.type == "cpu":
        return conv3x3_cat_bf16_plain(inputs, weight, scale, bias, act, slope)
    cout = weight.shape[0]
    if not (cout in KERNEL_COUTS or cout % 64 == 0):
        raise ValueError("the bf16 K3 takes Cout 8, 16, 32, 64 or a multiple "
                         f"of 64; got {cout}")
    _require_cuda(inputs[0], "conv3x3_cat_bf16",
                  GRID_Z // max(1, cout // 64))
    if kweight_bf16 is None:
        kweight_bf16 = kernel_weight_bf16(weight)
    _check_kweight(kweight_bf16, weight, cout + (-cout % 16), torch.bfloat16)
    return _launch("conv3x3_cat_bf16", inputs, kweight_bf16, scale, bias, act,
                   slope, cout)


def conv3x3_cat(inputs, weight, scale=None, bias=None, act=None, slope=0.2,
                kweight=None, kweight_bf16=None):
    """K3 at the current stage's precision: on CUDA the f32 kernel (any
    batch up to 65535, Cout in 8/16/32/64) or, in a bf16 stage,
    ``conv3x3_cat_bf16``; on CPU the twin of that precision.

    inputs: list of 1-5 NHWC tensors; weight: (Cout, sum Ci, 3, 3);
    scale/bias: (Cout,) or None; act: None | 'relu' | 'lrelu';
    kweight / kweight_bf16: ``kernel_weight(weight)`` /
    ``kernel_weight_bf16(weight)`` if the caller keeps them, else they are
    laid out here.
    """
    if fnn.bf16_stage():
        return conv3x3_cat_bf16(inputs, weight, scale, bias, act, slope,
                                kweight_bf16)
    inputs = list(inputs)
    _check(inputs, weight, act)
    if inputs[0].device.type == "cpu":
        return conv3x3_cat_plain(inputs, weight, scale, bias, act, slope)
    _require_cuda(inputs[0], "conv3x3_cat", GRID_Z)
    cout = weight.shape[0]
    if cout not in KERNEL_COUTS:
        raise ValueError(f"K3 takes Cout in {KERNEL_COUTS}; got {cout}")
    if kweight is None:
        kweight = kernel_weight(weight)
    _check_kweight(kweight, weight, cout, torch.float32)
    return _launch("conv3x3_cat", inputs, kweight, scale, bias, act, slope,
                   cout)


def conv3x3_fused(x, weight, scale=None, bias=None, act=None, slope=0.2):
    """K6: one input, any Cout, f32 in every mode (the JAX kernel has no
    pass count).  x: (1, H, W, Cin); weight OIHW (Cout, Cin, 3, 3);
    scale/bias: (Cout,) or None.  On CUDA it runs K3's f32 kernel: Cout in
    64-wide launches, each padded up to the next of K3's widths with zero
    weight rows and cropped; on CPU ``conv3x3_cat_plain([x], ...)``."""
    _check([x], weight, act)
    if x.device.type == "cpu":
        return conv3x3_cat_plain([x], weight, scale, bias, act, slope)
    _require_cuda(x, "conv3x3_fused")
    outs = []
    for lo in range(0, weight.shape[0], 64):
        w = weight[lo:lo + 64].float()
        n = w.shape[0]
        pad = next(c for c in KERNEL_COUTS if c >= n) - n
        s, b = (None if t is None else F.pad(t[lo:lo + n].float(), (0, pad),
                                             value=v)
                for t, v in ((scale, 1.0), (bias, 0.0)))
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad))
        y = _launch("conv3x3_cat", [x], kernel_weight(w), s, b, act, slope,
                    n + pad, counter="conv3x3_fused")
        outs.append(y[..., :n])
    return torch.cat(outs, -1) if len(outs) > 1 else outs[0].contiguous()
