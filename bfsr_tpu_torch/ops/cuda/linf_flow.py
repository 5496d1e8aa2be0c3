"""K1 and K4: the pointwise flow, forward (z only) and inverse.

Kernels: ``bfsr_tpu_torch/csrc/linf_flow.cu`` (K1, d = 3), which replaces
``bfsr_tpu/ops/pallas/linf_flow.py:_forward_kernel`` / ``_inverse_kernel``,
and ``bfsr_tpu_torch/csrc/linf_flow_nd.cuh`` (K4, d in 12 / 27 / 48, the
patch models; its C entries are ``linf_flow_nd_{forward,inverse}.cu``),
which replaces ``_forward_kernel_nd`` / ``_inverse_kernel_nd``.

Layouts: z and x are (N, d) row-major; the affine info is channel-major
(2dL, N), as ``ops/cuda/linf_info.py`` writes it: rows 2di..2di+d-1 are
layer i's s, the next d rows its t.  Any number of layers L; a batch of
samples is one flat N.  A CPU tensor runs the plain twin below; a CUDA
tensor launches K1 (d = 3) or K4 (``KERNEL_ND_DIMS``), or raises.

``FlowInverse`` (``flow_inverse_diff``) is the inverse with a gradient
with respect to z, for the trainer: the frozen flow's weights and info
take none.  Its forward is ``flow_inverse``; its backward runs the plain
twin, as ``bfsr_tpu/models/edsr.py:_edsr_fused_diff`` gives a kernel with
no differentiation rule the VJP of its plain form: the JAX package has no
backward kernel for the flow, so neither has the port.
"""

import torch

from bfsr_tpu_torch.ops import cuda
from bfsr_tpu_torch.ops.pointwise_flow import AFFINE_EPS

KERNEL_ND_DIMS = (12, 27, 48)


def _affine_cm(info_cm, i, d):
    """Layer i's (scale, shift), each (N, d), from (2dL, N) info."""
    s = info_cm[2 * d * i:2 * d * i + d].T
    t = info_cm[2 * d * i + d:2 * d * (i + 1)].T
    return torch.sigmoid(s + 2.0) + AFFINE_EPS, t


def flow_forward_plain(w, b, x, info_cm):
    """Plain twin of the forward kernels: w (L+1, d, d), b (L+1, d),
    x (N, d), info_cm (2dL, N) -> z (N, d)."""
    n_layers, d = w.shape[0] - 1, w.shape[-1]
    z = x
    for i in range(n_layers):
        scale, shift = _affine_cm(info_cm, i, d)
        z = (z @ w[i].T + b[i]) * scale + shift
    return z @ w[n_layers].T + b[n_layers]


def flow_inverse_plain(w_inv, b, z, info_cm):
    """Plain twin of the inverse kernels with cached inverses
    w_inv (L+1, d, d)."""
    n_layers, d = w_inv.shape[0] - 1, w_inv.shape[-1]
    x = (z - b[n_layers]) @ w_inv[n_layers].T
    for i in reversed(range(n_layers)):
        scale, shift = _affine_cm(info_cm, i, d)
        x = ((x - shift) / scale - b[i]) @ w_inv[i].T
    return x


def _check(w, b, x, info_cm):
    n_layers, d = w.shape[0] - 1, w.shape[-1]
    if w.shape[1:] != (d, d) or b.shape != (n_layers + 1, d):
        raise ValueError(f"flow weights must be (L+1, d, d) and (L+1, d): "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"x must be (N, {d}), got {tuple(x.shape)}")
    if info_cm.shape != (2 * d * n_layers, x.shape[0]):
        raise ValueError(f"info must be ({2 * d * n_layers}, {x.shape[0]}), "
                         f"got {tuple(info_cm.shape)}")
    return n_layers, d


def _run(direction, plain, w, b, x, info_cm):
    n_layers, d = _check(w, b, x, info_cm)
    if x.device.type == "cpu":
        return plain(w, b, x, info_cm)
    if x.device.type != "cuda":
        raise ValueError(f"linf_flow_{direction}: unsupported device "
                         f"{x.device}")
    if d != 3 and d not in KERNEL_ND_DIMS:
        raise ValueError(f"the flow kernels take d = 3 (K1) or d in "
                         f"{KERNEL_ND_DIMS} (K4); got d = {d}")
    name = f"linf_flow_{direction}" if d == 3 else f"linf_flow_nd_{direction}"
    cuda.check_cuda(name, w, b, x, info_cm)
    out = torch.empty_like(x)
    args = [cuda.ptr(w), cuda.ptr(b), cuda.ptr(x), cuda.ptr(info_cm),
            cuda.ptr(out), x.shape[0], n_layers]
    cuda.launch(name, *args, *(() if d == 3 else (d,)))
    return out


def flow_forward(w, b, x, info_cm):
    """z = flow(x): K1 / K4 on CUDA, the twin on CPU."""
    return _run("forward", flow_forward_plain, w, b, x, info_cm)


def flow_inverse(w_inv, b, z, info_cm):
    """x = flow^-1(z): K1 / K4 on CUDA, the twin on CPU."""
    return _run("inverse", flow_inverse_plain, w_inv, b, z, info_cm)


class FlowInverse(torch.autograd.Function):
    """x = flow^-1(z) through ``flow_inverse`` (K1 / K4 on CUDA), with the
    gradient with respect to z of the plain twin: the backward recomputes
    ``flow_inverse_plain`` of the saved z and info under autograd and
    returns its vector-Jacobian product for z only."""

    @staticmethod
    def forward(ctx, w_inv, b, z, info_cm):
        ctx.save_for_backward(w_inv, b, z, info_cm)
        return flow_inverse(w_inv, b, z, info_cm)

    @staticmethod
    def backward(ctx, grad_x):
        w_inv, b, z, info_cm = ctx.saved_tensors
        with torch.enable_grad():
            zr = z.detach().requires_grad_(True)
            x = flow_inverse_plain(w_inv, b, zr, info_cm)
            (grad_z,) = torch.autograd.grad(x, zr, grad_x)
        return None, None, grad_z, None


def flow_inverse_diff(w_inv, b, z, info_cm):
    """``flow_inverse`` that autograd differentiates with respect to z."""
    return FlowInverse.apply(w_inv, b, z, info_cm)
