"""K5: one fused conditional SRFlow FlowStep, eval only.

Kernel: ``bfsr_tpu_torch/csrc/flow_step.cu``, which replaces
``bfsr_tpu/ops/pallas/flow_step.py:_fwd_kernel`` / ``_rev_kernel``
(``step_apply``).

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

A step's weights are one float32 buffer (``pack_step``), laid out once at
``freeze()`` in the kernel's order: the folded actnorm + invconv pair of
both directions, the tower with ``exp(3 * logs)`` folded into W3 and b3
and the 'cross' split de-interleaved into ``[scales | shifts]``.  The
plain twins read the same buffer through ``unpack_step``, so the CPU
tests hold the layout against the JAX package.  A CPU tensor runs the
twin; a CUDA tensor launches the kernel or raises.
"""

import torch

from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.flows import AFFINE_EPS, fold_actnorm_invconv

KERNEL_CHANNELS = (12, 24, 96)
KERNEL_HIDDEN = 64


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
def pack_step(an, invconv, affine):
    """One conditional step's weights -> its packed float32 buffer.

    an / invconv / affine: the step's ``ActNorm``, ``InvConv1x1`` and
    ``CondAffine`` (``bfsr_tpu_torch.ops.flows``).  Layouts: W1 as
    (tap, cn, hid), W2 as (in, out), W3 as (tap, hid, 2co) with its output
    channels reordered [scales | shifts] and the gain folded in."""
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
    w3 = (out.weight * gain[:, None, None, None])[order]     # (2co, hid, 3, 3)
    b3 = (out.bias * gain)[order]
    parts = {
        **fold,
        "w1": w1.permute(2, 3, 1, 0),
        "an1_b": an1_b, "an1_e": torch.exp(an1_s),
        "w2": tower[2].weight[:, :, 0, 0].T,
        "an2_b": an2_b, "an2_e": torch.exp(an2_s),
        "w3": w3.permute(2, 3, 1, 0), "b3": b3,
    }
    return torch.cat([parts[k].reshape(-1).float()
                      for k, _ in _layout(c, w1.shape[0])]).contiguous()


def unpack_step(packed, c, hid):
    """Views of a packed step by name (``_layout``)."""
    out, off = {}, 0
    for name, shape in _layout(c, hid):
        n = 1
        for s in shape:
            n *= s
        out[name] = packed[off:off + n].reshape(shape)
        off += n
    if off != packed.numel():
        raise ValueError(f"packed step holds {packed.numel()} floats, the "
                         f"layout of C={c}, hidden={hid} {off}")
    return out


def _tower(z1, aff1, p):
    """(scale, shift) of the coupling tower on z1 (1, H, W, cn)."""
    hid = p["an1_b"].shape[0]
    w1 = p["w1"].reshape(3, 3, -1, hid).permute(3, 2, 0, 1)
    h = torch.relu((fnn.conv2d(z1, w1) + aff1 + p["an1_b"]) * p["an1_e"])
    h = torch.relu((h @ p["w2"] + p["an2_b"]) * p["an2_e"])
    w3 = p["w3"].reshape(3, 3, hid, -1).permute(3, 2, 0, 1)
    o = fnn.conv2d(h, w3, p["b3"])
    co = o.shape[-1] // 2
    return torch.sigmoid(o[..., :co] + 2.0) + AFFINE_EPS, o[..., co:]


def flow_step_forward_plain(x, cond, packed, hid):
    """Plain twin of the forward kernel: F.conv2d and elementwise ops."""
    c = x.shape[-1]
    cn = c // 2
    p = unpack_step(packed, c, hid)
    za = (x @ p["w_fold"].T + p["b_fold"] + cond[..., c:2 * c]) * cond[..., :c]
    z1 = za[..., :cn]
    scale, shift = _tower(z1, cond[..., 2 * c:], p)
    return torch.cat([z1, (za[..., cn:] + shift) * scale], -1)


def flow_step_reverse_plain(x, cond, packed, hid):
    """Plain twin of the reverse kernel."""
    c = x.shape[-1]
    cn = c // 2
    p = unpack_step(packed, c, hid)
    scale, shift = _tower(x[..., :cn], cond[..., 2 * c:], p)
    t = torch.cat([x[..., :cn], x[..., cn:] / scale - shift], -1)
    t = t / cond[..., :c] - cond[..., c:2 * c]
    return t @ p["w_inv_fold"].T - p["an_bias"]


def _check(x, cond, packed, hid):
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"flow step: x must be (1, H, W, C), got "
                         f"{tuple(x.shape)}")
    _, H, W, c = x.shape
    if cond.shape != (1, H, W, 2 * c + hid):
        raise ValueError(f"flow step: cond {tuple(cond.shape)} is not "
                         f"(1, {H}, {W}, 2C + hidden = {2 * c + hid})")
    unpack_step(packed, c, hid)


def _run(name, x, cond, packed, hid, plain):
    _check(x, cond, packed, hid)
    if x.device.type == "cpu":
        return plain(x, cond, packed, hid)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _, H, W, c = x.shape
    if c not in KERNEL_CHANNELS or hid != KERNEL_HIDDEN:
        raise ValueError(f"K5 takes C in {KERNEL_CHANNELS} and hidden "
                         f"{KERNEL_HIDDEN}; got C={c}, hidden={hid}")
    # the kernel reads float4s: every base pointer 16-byte aligned
    x, cond = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (x, cond))
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: the packed weights are not 16-byte aligned")
    out = torch.empty_like(x)
    cuda.check_cuda(name, x, cond, packed, out)
    cuda.launch(name, cuda.ptr(x), cuda.ptr(cond), cuda.ptr(packed),
                cuda.ptr(out), H, W, c, hid)
    return out


def flow_step_forward(x, cond, packed, hid):
    """K5 forward on CUDA (C in 12/24/96, hidden 64), the twin on CPU.

    x: (1, H, W, C) state; cond: (1, H, W, 2C + hid) record; packed: the
    step's ``pack_step`` buffer.  Returns the next state (1, H, W, C)."""
    return _run("flow_step_forward", x, cond, packed, hid,
                flow_step_forward_plain)


def flow_step_reverse(x, cond, packed, hid):
    """K5 reverse on CUDA, the twin on CPU (see ``flow_step_forward``)."""
    return _run("flow_step_reverse", x, cond, packed, hid,
                flow_step_reverse_plain)
