"""K5: one fused conditional SRFlow FlowStep, eval only, in two forms.

Kernels: ``bfsr_tpu_torch/csrc/flow_step.cu`` (f32) and
``bfsr_tpu_torch/csrc/flow_step_bf16.cu`` (the one-pass forms: bf16
operands, f32 accumulation, the tower's three convs on tensor cores),
which replace ``bfsr_tpu/ops/pallas/flow_step.py:_fwd_kernel`` /
``_rev_kernel`` (``step_apply``) at passes 3 and 1.

Per pixel, with ``cn = C // 2``, ``co = C - cn`` and a conditioning record
``cond = [scale_ft | shift_ft | aff1_ft]`` (``flows.cond_affine_cache_batched``):

forward   za = (x @ Wfold^T + b_fold + shift_ft) * scale_ft;  z1 = za[:cn]
          (scale, shift) = tower(z1);  out = [z1 | (za[cn:] + shift) * scale]
reverse   (scale, shift) = tower(x[:cn]);  x2 = x[cn:] / scale - shift
          out = ([x1 | x2] / scale_ft - shift_ft) @ Winvfold^T - an_bias

with ``tower(z1)``: ``h = relu((conv3x3(z1; W1) + aff1_ft + an1_b) * an1_e)``,
``h = relu((h @ W2 + an2_b) * an2_e)``, ``o = conv3x3(h; W3) + b3``,
``scale = sigmoid(o[:co] + 2) + 1e-4``, ``shift = o[co:]``.  Each conv pads
with zeros of its own input: z1 outside the image is zero, and so is the
hidden map ``h`` (which otherwise carries the actnorm biases there).

A step's f32 weights are one float32 buffer (``pack_step``), laid out once
at ``freeze()`` in the kernel's order: the folded actnorm + invconv pair of
both directions, the tower with ``exp(3 * logs)`` folded into W3 and b3
and the 'cross' split de-interleaved into ``[scales | shifts]``.

Under ``BFSR_PRECISION=default`` (a bf16 stage) K5 runs one of two
one-pass forms, each the JAX package's numerics on one of its paths:

- ``step_form="xla"``, the form ``SRFlowLPPredictor`` serves: the JAX
  predictor's XLA step (its FlowStep kernel is off by default,
  ``bfsr_tpu/pipelines/srflow_eval.py:30-46``).  The folds run f32 on the
  unrounded state / ``t`` with the unrounded fold weights
  (``Precision.HIGHEST``, ``bfsr_tpu/ops/flows.py:144-154``); only conv1,
  conv2 and conv3 of the coupling tower take bf16-rounded operands
  (``:386-396``); W3 is rounded unscaled and the gain ``exp(3 * logs)``
  multiplies conv3's f32 sum after its bias (``flow_conv_zeros``,
  ``:237-240``), as the port's unfused ``FlowStep`` does.  Its buffer
  (``pack_step_bf16(..., "xla")``) carries the gain as a vector.
- ``step_form="pallas"``: the JAX FlowStep kernel at passes=1
  (``bfsr_tpu/ops/pallas/flow_step.py:_fwd_kernel`` / ``_rev_kernel``,
  ``BFSR_SRFLOW_STEP_KERNEL=on``).  It also rounds the state before the
  forward fold and ``t = [x1 | x2] / scale_ft - shift_ft`` before the
  reverse fold, keeps the fold weights rounded, and folds the gain into W3
  before rounding it (``flow_step.py:31, 112``): ``round(W3 * g)`` where the
  XLA step has ``round(W3) * g``.

In both, every bias, the actnorm vectors, the records, the sigmoid and the
coupling's multiply and divide stay f32, and the products sum in f32.  A
frozen step keeps the buffer of its ``step_form`` as ``kpacked_bf16``.

``flow_step_forward`` / ``flow_step_reverse`` read the stage's precision
at each call (``ops/nn.py``): the one-pass form named by ``step_form`` in
a bf16 stage, f32 elsewhere.  A CPU tensor runs the plain twin of that
form; a CUDA tensor launches that kernel or raises.  The twins read the
same buffers (``unpack_step``, ``unpack_step_bf16``), so the CPU tests hold
the layouts against the JAX package.  Every form takes a batch (B, H, W,
C) of states with their own records and one shared buffer: the kernels
launch the image as the grid's z, and a batch-1 launch is the launch it
was before.  ``FlowStepReverse`` is the reverse that autograd
differentiates with respect to the state (the SRFlow-LP prior trainer's
image loss): the kernel forward, the matching twin's gradient.

Inside ``ops.nn.width_sharded`` ``flow_step_forward``,
``flow_step_reverse`` and their ``_twin`` s take the strip's records with
``halo.STEP_HALO`` = 2 columns of each neighbour (``precompute_ft`` keeps
them), give the state the same 2 (one exchange) and crop the step's
output: conv1 and conv3 are both 3x3, and each pads with zeros of its own
input only at the image's true edges.
"""

import torch
import torch.nn.functional as F

from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.flows import AFFINE_EPS, fold_actnorm_invconv
from bfsr_tpu_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw
from bfsr_tpu_torch.ops import halo

# the flow levels' widths: 12 / 24 / 96 of the 4x model's L 3 flow, 12 /
# 24 / 48 / 192 of the 8x model's L 4 flow
KERNEL_CHANNELS = (12, 24, 48, 96, 192)
KERNEL_HIDDEN = 64
# the image is the grid's z
GRID_Z = 65535


def _layout(c, hid):
    """[(name, shape)] of a packed step, in buffer order."""
    cn = c // 2
    co = c - cn
    return [("w_fold", (c, c)), ("b_fold", (c,)),
            ("w_inv_fold", (c, c)), ("an_bias", (c,)),
            ("w1", (9, cn, hid)), ("an1_b", (hid,)), ("an1_e", (hid,)),
            ("w2", (hid, hid)), ("an2_b", (hid,)), ("an2_e", (hid,)),
            ("w3", (9, hid, 2 * co)), ("b3", (2 * co,))]


@torch.no_grad()
def _step_parts(an, invconv, affine):
    """A conditional step's weights by name in the kernels' layouts: the
    folds, W1 as (tap, cn, hid), W2 as (in, out), W3 as (tap, hid, 2co)
    and b3 with their output channels reordered [scales | shifts], W3 and
    b3 unscaled, and ``g3``, the Conv2dZeros gain ``exp(3 * logs)`` in the
    same order."""
    fold = fold_actnorm_invconv(an, invconv)
    tower = affine.fAffine
    c = fold["w_fold"].shape[0]
    cn = c // 2
    co = c - cn
    w1 = tower[0].weight[:, :cn]                             # (hid, cn, 3, 3)
    an1_b, an1_s = tower[0].actnorm.vectors()
    an2_b, an2_s = tower[2].actnorm.vectors()
    out = tower[4]
    gain = torch.exp(out.logs.reshape(-1) * 3.0)
    order = torch.cat([torch.arange(co) * 2 + 1, torch.arange(co) * 2])
    order = order.to(gain.device)
    return {
        **fold,
        "w1": w1.permute(2, 3, 1, 0),
        "an1_b": an1_b, "an1_e": torch.exp(an1_s),
        "w2": tower[2].weight[:, :, 0, 0].T,
        "an2_b": an2_b, "an2_e": torch.exp(an2_s),
        "w3": out.weight[order].permute(2, 3, 1, 0), "b3": out.bias[order],
        "g3": gain[order],
    }


def _fold_gain(parts):
    """``parts`` with the gain folded into W3 and b3 (and dropped)."""
    parts = dict(parts)
    g = parts.pop("g3")
    parts["w3"], parts["b3"] = parts["w3"] * g, parts["b3"] * g
    return parts


@torch.no_grad()
def pack_step(an, invconv, affine):
    """One conditional step's weights -> its packed float32 buffer.

    an / invconv / affine: the step's ``ActNorm``, ``InvConv1x1`` and
    ``CondAffine`` (``bfsr_tpu_torch.ops.flows``).  Layouts as
    ``_step_parts``, with the gain folded into W3 and b3."""
    parts = _fold_gain(_step_parts(an, invconv, affine))
    c = parts["w_fold"].shape[0]
    return torch.cat([parts[k].reshape(-1).float()
                      for k, _ in _layout(c, parts["w2"].shape[0])]
                     ).contiguous()


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _views(flat, layout, off=0):
    """{name: view} of ``layout``'s entries in ``flat`` from ``off``, and
    the offset past the last."""
    out = {}
    for name, shape in layout:
        n = _numel(shape)
        out[name] = flat[off:off + n].reshape(shape)
        off += n
    return out, off


def unpack_step(packed, c, hid):
    """Views of a packed step by name (``_layout``)."""
    out, off = _views(packed, _layout(c, hid))
    if off != packed.numel():
        raise ValueError(f"packed step holds {packed.numel()} floats, the "
                         f"layout of C={c}, hidden={hid} {off}")
    return out


STEP_FORMS = ("xla", "pallas")


def _check_form(form):
    if form not in STEP_FORMS:
        raise ValueError(f"step_form must be one of {STEP_FORMS}, got "
                         f"{form!r}")


def _layout_bf16(c, hid, form="xla"):
    """A one-pass buffer: ([(name, shape)] of its f32 words, [(name,
    shape)] of its bf16 values), in buffer order.  The f32 words hold the
    vectors and both folds (the ``pallas`` form's folds bf16 values in f32
    words): the kernel's fold loops run f32 FMA.  The bf16 values are the
    tower's three tensor-core operands: W1 as (tap * cn + channel, hid)
    rows, zero rows to a multiple of 16; W2; W3.  b3, the ``xla`` form's
    gain g3 and W3's output columns are interleaved, (scale j, shift j) at
    columns (2j, 2j + 1), so that one lane of the tensor-core tile holds
    both halves of a channel, and zero-padded from 2co to a multiple of 16.
    """
    _check_form(form)
    cn = c // 2
    n3 = -(-2 * (c - cn) // 16) * 16
    k1p = -(-9 * cn // 16) * 16
    gain = [("g3", (n3,))] if form == "xla" else []
    f32 = ([("b_fold", (c,)), ("an_bias", (c,)),
            ("an1_b", (hid,)), ("an1_e", (hid,)),
            ("an2_b", (hid,)), ("an2_e", (hid,)), ("b3", (n3,))] + gain
           + [("w_fold", (c, c)), ("w_inv_fold", (c, c))])
    bf16 = [("w1", (k1p, hid)), ("w2", (hid, hid)), ("w3", (9, hid, n3))]
    return f32, bf16


def _interleave(t):
    """Last dim [scales | shifts] -> (scale j, shift j) pairs."""
    co = t.shape[-1] // 2
    return torch.stack([t[..., :co], t[..., co:]], -1).flatten(-2)


def _deinterleave(t):
    """Inverse of ``_interleave``."""
    return torch.cat([t[..., 0::2], t[..., 1::2]], -1)


def _f32_words(c, hid, form="xla"):
    """f32 words before the bf16 part: a multiple of 8 (32 bytes)."""
    n = sum(_numel(s) for _, s in _layout_bf16(c, hid, form)[0])
    return -(-n // 8) * 8


def _packed_numel(c, hid, form=None):
    """Elements of a packed step: floats of ``pack_step`` (``form`` None),
    or bf16 values of ``pack_step_bf16`` in ``form``."""
    if form is not None:
        return 2 * _f32_words(c, hid, form) + sum(
            _numel(s) for _, s in _layout_bf16(c, hid, form)[1])
    return sum(_numel(s) for _, s in _layout(c, hid))


@torch.no_grad()
def pack_step_bf16(an, invconv, affine, form="xla"):
    """One conditional step's weights -> its one-pass buffer (bf16, 1-D)
    in ``form`` (``STEP_FORMS``): the f32 words of ``_layout_bf16``, then
    W1, W2 and W3 in bf16.  ``xla``: the folds and every vector f32, W1,
    W2 and W3 (unscaled) rounded, the gain g3 as a vector.  ``pallas``:
    the gain folded into W3 and b3 first, then the folds, W1, W2 and W3
    rounded."""
    _check_form(form)
    p = _step_parts(an, invconv, affine)
    c, hid = p["w_fold"].shape[0], p["w2"].shape[0]
    if form == "pallas":
        p = _fold_gain(p)
        for k in ("w_fold", "w_inv_fold"):
            p[k] = fnn.round_bf16(p[k])
    f32_layout, bf16_layout = _layout_bf16(c, hid, form)
    n3 = dict(f32_layout)["b3"][0]
    k1p = dict(bf16_layout)["w1"][0]
    co2 = p["b3"].shape[0]
    for k in ("b3", "g3", "w3"):
        if k in p:
            p[k] = F.pad(_interleave(p[k]), (0, n3 - co2))
    w1 = p["w1"].reshape(-1, hid)
    p["w1"] = F.pad(w1, (0, 0, 0, k1p - w1.shape[0]))
    words = torch.cat([p[k].reshape(-1).float() for k, _ in f32_layout])
    words = F.pad(words, (0, _f32_words(c, hid, form) - words.numel()))
    return torch.cat([words.view(torch.bfloat16)]
                     + [p[k].reshape(-1).float().to(torch.bfloat16)
                        for k, _ in bf16_layout]).contiguous()


def _check_bf16(packed):
    if packed is None or packed.dtype != torch.bfloat16:
        raise ValueError("the one-pass K5 form needs the step's bf16 buffer "
                         "(kpacked_bf16; re-run freeze()), got "
                         f"{None if packed is None else packed.dtype}")


def unpack_step_bf16(packed, c, hid, dtype=torch.float32, form="xla"):
    """A one-pass buffer's weights by name, as ``dtype`` tensors in the
    twins' layouts (``_step_parts``): W1 as (9, cn, hid), b3, g3 and W3
    cropped to their 2co columns in [scales | shifts] order."""
    _check_bf16(packed)
    want = _packed_numel(c, hid, form)
    if packed.numel() != want:
        raise ValueError(f"one-pass packed step holds {packed.numel()} bf16 "
                         f"values, the {form} layout of C={c}, hidden={hid} "
                         f"{want}")
    f32_layout, bf16_layout = _layout_bf16(c, hid, form)
    nw = _f32_words(c, hid, form)
    out, _ = _views(packed[:2 * nw].view(torch.float32), f32_layout)
    rest, _ = _views(packed, bf16_layout, 2 * nw)
    out.update(rest)
    cn = c // 2
    co2 = 2 * (c - cn)
    for k in ("b3", "g3", "w3"):
        if k in out:
            out[k] = _deinterleave(out[k][..., :co2])
    out["w1"] = out["w1"][:9 * cn].reshape(9, cn, hid)
    return {k: v.to(dtype) for k, v in out.items()}


def _conv3x3(x, w, b=None):
    return nchw_to_nhwc(F.conv2d(nhwc_to_nchw(x), w, b, padding=1))


def _mm(a, w, b=None):
    return a @ w


def _mm_t(a, w, b=None):
    return a @ w.T


def _keep(t):
    return t


def _diff_bf16(t):
    """As ``rnd``: round to bf16, and differentiate each product as a bf16
    stage's (``fnn._bf16_product``: the roundings pass the gradient
    straight through, the gradient into the product is rounded)."""
    return fnn.round_bf16(t)


def _prod(op, a, w, b=None, rnd=_keep):
    """``op(rnd(a), w, b)``: a product of the activation ``a`` and a
    weight (bf16 values in a one-pass buffer), the bias ``b`` added."""
    if rnd is _diff_bf16:
        return fnn._bf16_product(op, a, w, b, (0, 1, 2))
    return op(rnd(a), w, b)


def _per_image(fn):
    """``fn(x, cond, ...)`` one image at a time, as the kernels take them:
    an image's bits then do not depend on the batch around it, which
    batched library convs and vectorised elementwise ops (their tails) do
    not promise."""
    def run(x, cond, *args):
        if x.shape[0] == 1:
            return fn(x, cond, *args)
        return torch.cat([fn(x[i:i + 1], cond[i:i + 1], *args)
                          for i in range(x.shape[0])])
    return run


def _tower(z1, aff1, p, rnd=_keep):
    """(scale, shift) of the coupling tower on z1 (B, H, W, cn); ``rnd``
    rounds the activation operand of each of its three products.  With a
    gain ``g3`` in ``p`` it multiplies conv3's output after the bias."""
    hid = p["an1_b"].shape[0]
    w1 = p["w1"].reshape(3, 3, -1, hid).permute(3, 2, 0, 1)
    h = torch.relu((_prod(_conv3x3, z1, w1, rnd=rnd) + aff1 + p["an1_b"])
                   * p["an1_e"])
    h = torch.relu((_prod(_mm, h, p["w2"], rnd=rnd) + p["an2_b"])
                   * p["an2_e"])
    w3 = p["w3"].reshape(3, 3, hid, -1).permute(3, 2, 0, 1)
    o = _prod(_conv3x3, h, w3, p["b3"], rnd)
    if "g3" in p:
        o = o * p["g3"]
    co = o.shape[-1] // 2
    return torch.sigmoid(o[..., :co] + 2.0) + AFFINE_EPS, o[..., co:]


def _forward_batch(x, cond, p, rnd=_keep, fold_rnd=_keep):
    c = x.shape[-1]
    cn = c // 2
    za = ((_prod(_mm_t, x, p["w_fold"], rnd=fold_rnd) + p["b_fold"]
           + cond[..., c:2 * c]) * cond[..., :c])
    z1 = za[..., :cn]
    scale, shift = _tower(z1, cond[..., 2 * c:], p, rnd)
    return torch.cat([z1, (za[..., cn:] + shift) * scale], -1)


def _reverse_batch(x, cond, p, rnd=_keep, fold_rnd=_keep):
    c = x.shape[-1]
    cn = c // 2
    scale, shift = _tower(x[..., :cn], cond[..., 2 * c:], p, rnd)
    t = torch.cat([x[..., :cn], x[..., cn:] / scale - shift], -1)
    t = t / cond[..., :c] - cond[..., c:2 * c]
    return _prod(_mm_t, t, p["w_inv_fold"], rnd=fold_rnd) - p["an_bias"]


# the plain twins compute image by image (``_per_image``); FlowStepReverse's
# backward differentiates the batch at once
_forward = _per_image(_forward_batch)
_reverse = _per_image(_reverse_batch)


def flow_step_forward_plain(x, cond, packed, hid):
    """Plain twin of the f32 forward kernel: F.conv2d and elementwise ops,
    f32 in every mode."""
    return _forward(x, cond, unpack_step(packed, x.shape[-1], hid))


def flow_step_reverse_plain(x, cond, packed, hid):
    """Plain twin of the f32 reverse kernel."""
    return _reverse(x, cond, unpack_step(packed, x.shape[-1], hid))


def flow_step_forward_bf16_plain(x, cond, packed_bf16, hid):
    """Plain twin of the served (``xla``) one-pass forward kernel: the
    weights of ``packed_bf16``, the fold in f32 on the unrounded state,
    the operands of conv1, conv2 and conv3 rounded with
    ``fnn.round_bf16``, the gain after conv3, sums in x's dtype."""
    p = unpack_step_bf16(packed_bf16, x.shape[-1], hid, x.dtype)
    return _forward(x, cond, p, fnn.round_bf16)


def flow_step_reverse_bf16_plain(x, cond, packed_bf16, hid):
    """Plain twin of the served (``xla``) one-pass reverse kernel: conv1-3
    as forward, the inverse fold in f32 on the unrounded ``t``."""
    p = unpack_step_bf16(packed_bf16, x.shape[-1], hid, x.dtype)
    return _reverse(x, cond, p, fnn.round_bf16)


def flow_step_forward_bf16_pallas_plain(x, cond, packed_bf16, hid):
    """Plain twin of the ``pallas`` one-pass forward kernel: the weights
    of a ``pallas`` buffer, the operands of all five products rounded."""
    p = unpack_step_bf16(packed_bf16, x.shape[-1], hid, x.dtype, "pallas")
    return _forward(x, cond, p, fnn.round_bf16, fnn.round_bf16)


def flow_step_reverse_bf16_pallas_plain(x, cond, packed_bf16, hid):
    """Plain twin of the ``pallas`` one-pass reverse kernel: conv1-3 as
    forward, then ``t`` rounded before the inverse fold."""
    p = unpack_step_bf16(packed_bf16, x.shape[-1], hid, x.dtype, "pallas")
    return _reverse(x, cond, p, fnn.round_bf16, fnn.round_bf16)


def _check(x, cond, packed, hid, form):
    if x.ndim != 4:
        raise ValueError(f"flow step: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    B, H, W, c = x.shape
    if cond.shape != (B, H, W, 2 * c + hid):
        raise ValueError(f"flow step: cond {tuple(cond.shape)} is not "
                         f"({B}, {H}, {W}, 2C + hidden = {2 * c + hid})")
    if form is not None:
        _check_bf16(packed)
    want = _packed_numel(c, hid, form)
    if packed.numel() != want:     # counted, not unpacked: a launch's
        raise ValueError(          # host time stays below the kernel's
            f"packed step holds {packed.numel()} values, the "
            f"{form + ' one-pass ' if form else ''}layout of C={c}, "
            f"hidden={hid} {want}")


def _run(name, x, cond, packed, hid, plain, form=None):
    _check(x, cond, packed, hid, form)
    if x.device.type == "cpu":
        return plain(x, cond, packed, hid)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    B, H, W, c = x.shape
    if c not in KERNEL_CHANNELS or hid != KERNEL_HIDDEN:
        raise ValueError(f"K5 takes C in {KERNEL_CHANNELS} and hidden "
                         f"{KERNEL_HIDDEN}; got C={c}, hidden={hid}")
    if B > GRID_Z:
        raise ValueError(f"K5 takes a batch of at most {GRID_Z}, got {B}")
    # the kernels read float4s (and the bf16 forms 32-byte tensor-core
    # tiles of their buffer): every base pointer aligned
    x, cond = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (x, cond))
    dtype, align = ((torch.float32, 16) if form is None
                    else (torch.bfloat16, 32))
    if (packed.device != x.device or packed.dtype != dtype
            or not packed.is_contiguous()):
        raise ValueError(f"{name}: the packed weights must be contiguous "
                         f"{dtype} on {x.device}")
    if packed.data_ptr() % align:
        raise ValueError(f"{name}: the packed weights are not {align}-byte "
                         "aligned")
    out = torch.empty_like(x)
    cuda.check_cuda(name, x, cond, out)
    cuda.launch(name, cuda.ptr(x), cuda.ptr(cond), cuda.ptr(packed),
                cuda.ptr(out), B, H, W, c, hid)
    return out


# (step form, reverse) -> (the kernel's entry and counter, its plain twin)
BF16_FORMS = {
    ("xla", False): ("flow_step_bf16_forward", flow_step_forward_bf16_plain),
    ("xla", True): ("flow_step_bf16_reverse", flow_step_reverse_bf16_plain),
    ("pallas", False): ("flow_step_bf16_pallas_forward",
                        flow_step_forward_bf16_pallas_plain),
    ("pallas", True): ("flow_step_bf16_pallas_reverse",
                       flow_step_reverse_bf16_pallas_plain)}


def flow_step_forward(x, cond, packed, hid, packed_bf16=None,
                      step_form="xla"):
    """K5 forward at the stage's precision: on CUDA the f32 kernel or, in
    a bf16 stage, the one-pass kernel of ``step_form`` (C in
    ``KERNEL_CHANNELS``, hidden 64); on CPU the twin of that form.

    x: (B, H, W, C) state; cond: (B, H, W, 2C + hid) records; packed /
    packed_bf16: the step's ``pack_step`` / ``pack_step_bf16`` buffers (a
    frozen step's ``kpacked`` / ``kpacked_bf16``; the bf16 one, in
    ``step_form``, is needed in a bf16 stage only; the batch shares
    them).  Returns the next state (B, H, W, C)."""
    if fnn.width_shard():
        return halo.step(flow_step_forward, x, cond, packed, hid, packed_bf16,
                         step_form)
    if fnn.bf16_stage():
        _check_form(step_form)
        name, plain = BF16_FORMS[step_form, False]
        return _run(name, x, cond, packed_bf16, hid, plain, step_form)
    return _run("flow_step_forward", x, cond, packed, hid,
                flow_step_forward_plain)


def flow_step_reverse(x, cond, packed, hid, packed_bf16=None,
                      step_form="xla"):
    """K5 reverse at the stage's precision (see ``flow_step_forward``)."""
    if fnn.width_shard():
        return halo.step(flow_step_reverse, x, cond, packed, hid, packed_bf16,
                         step_form)
    if fnn.bf16_stage():
        _check_form(step_form)
        name, plain = BF16_FORMS[step_form, True]
        return _run(name, x, cond, packed_bf16, hid, plain, step_form)
    return _run("flow_step_reverse", x, cond, packed, hid,
                flow_step_reverse_plain)


def _stage_form(step_form):
    """The form of the stage's precision: ``step_form`` in a bf16 stage,
    else None (f32)."""
    if fnn.bf16_stage():
        _check_form(step_form)
        return step_form
    return None


def _reverse_diff(x, cond, packed, hid, form):
    """The reverse's twin in ``form`` (None: f32) on its buffer, the whole
    batch at once, which autograd differentiates with respect to x as a
    bf16 stage's products (``_diff_bf16``): ``FlowStepReverse``'s
    backward."""
    c = x.shape[-1]
    if form is None:
        return _reverse_batch(x, cond, unpack_step(packed, c, hid))
    p = unpack_step_bf16(packed, c, hid, x.dtype, form)
    return _reverse_batch(x, cond, p, _diff_bf16,
                          _diff_bf16 if form == "pallas" else _keep)


def _reverse_plain(x, cond, packed, hid, form):
    """The reverse's plain twin in ``form`` (None: f32), image by image."""
    if form is None:
        return flow_step_reverse_plain(x, cond, packed, hid)
    return BF16_FORMS[form, True][1](x, cond, packed, hid)


def flow_step_forward_twin(x, cond, packed, hid, packed_bf16=None,
                           step_form="xla"):
    """The plain twin of ``flow_step_forward`` at the stage's precision,
    on any device (no launch)."""
    if fnn.width_shard():
        return halo.step(flow_step_forward_twin, x, cond, packed, hid,
                         packed_bf16, step_form)
    form = _stage_form(step_form)
    if form is None:
        return flow_step_forward_plain(x, cond, packed, hid)
    return BF16_FORMS[form, False][1](x, cond, packed_bf16, hid)


class FlowStepReverse(torch.autograd.Function):
    """``flow_step_reverse`` (K5's reverse on CUDA, in the form of the
    stage's precision at the call; with ``twin`` its plain twin, on any
    device) with the gradient with respect to x of the matching twin: the
    backward recomputes that twin of the saved x, records and buffer under
    autograd, the batch at once (``_reverse_diff``: the one-pass forms'
    products differentiated as a bf16 stage's), and returns its
    vector-Jacobian product for x only."""

    @staticmethod
    def forward(ctx, x, cond, packed, hid, packed_bf16, step_form, twin):
        form = _stage_form(step_form)
        buf = packed if form is None else packed_bf16
        ctx.hid, ctx.form = hid, form
        ctx.save_for_backward(x, cond, buf)
        if twin:
            _check(x, cond, buf, hid, form)
            return _reverse_plain(x, cond, buf, hid, form)
        return flow_step_reverse(x, cond, packed, hid, packed_bf16, step_form)

    @staticmethod
    def backward(ctx, grad_out):
        x, cond, packed = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            y = _reverse_diff(xr, cond, packed, ctx.hid, ctx.form)
            (grad_x,) = torch.autograd.grad(y, xr, grad_out)
        return grad_x, None, None, None, None, None, None


def flow_step_reverse_twin(x, cond, packed, hid, packed_bf16=None,
                           step_form="xla"):
    """The plain twin of ``flow_step_reverse`` at the stage's precision, on
    any device (no launch), differentiable with respect to x as
    ``FlowStepReverse`` differentiates the kernel."""
    if fnn.width_shard():
        return halo.step(flow_step_reverse_twin, x, cond, packed, hid,
                         packed_bf16, step_form)
    return FlowStepReverse.apply(x, cond, packed, hid, packed_bf16,
                                 step_form, True)


def flow_step_reverse_diff(x, cond, packed, hid, packed_bf16=None,
                           step_form="xla"):
    """``flow_step_reverse`` that autograd differentiates with respect to
    x (``FlowStepReverse``)."""
    return FlowStepReverse.apply(x, cond, packed, hid, packed_bf16,
                                 step_form, False)
