"""The least time of a K5 launch (``ops.cuda.flow_step.k5_cost``), which
``profiling/k5_times.py`` and ``chip_smoke.py`` both report beside the
kernel's time: each product over the peak of what runs it, against the
bytes over 3.35 TB/s.  Pinned at the 8x flow's wide levels, 32^2 x 192 and
64^2 x 48 (a 512^2 sample's levels 4 and 3), in the f32 form and both
one-pass forms, and at a narrow width whose f32-grade folds run as f32
SIMT FMA."""

import pytest
import torch

from bfsr_tpu_torch.ops.cuda import flow_step
from bfsr_tpu_torch.ops.cuda.flow_step import k5_cost
from bfsr_tpu_torch.profiling.k5_times import random_step

HID = 64
# per pixel: the fold 2 C^2, conv1 2 * 9 * (C / 2) * 64, conv2 2 * 64^2,
# conv3 2 * 9 * 64 * C
FOLD = {192: 73728, 48: 4608, 96: 18432}
TOWER = {192: 339968, 48: 91136, 96: 174080}
# bytes: 4 * px * (C + (2C + 64) + C) for the state, the record and the
# output, plus what a launch reads of the packed buffer (f32: floats;
# one-pass: bf16 values): all of it but the other direction's fold, C x C
# f32 words (the whole buffer: 978176, 638976, 638208, 202304, 112384 and
# 112192 bytes)
READ_BYTES = {(192, "f32"): 830720, (192, "xla"): 491520,
              (192, "pallas"): 490752, (48, "f32"): 193088,
              (48, "xla"): 103168, (48, "pallas"): 102976}
PEAK = {"f32 SIMT": 67e12, "bf16": 989e12, "TF32": 495e12,
        "3xTF32": 495e12 / 3}


def _packed(c, form):
    step = random_step(c)
    if form == "f32":
        return flow_step.pack_step(step.actnorm, step.invconv, step.affine)
    return flow_step.pack_step_bf16(step.actnorm, step.invconv, step.affine,
                                    form)


@pytest.mark.parametrize("c,hw,form,rate,by", [
    (192, 32, "f32", "3xTF32", "operations"),
    (192, 32, "xla", "bf16 + 3xTF32", "bytes"),
    (192, 32, "pallas", "bf16", "bytes"),
    (48, 64, "f32", "3xTF32", "operations"),
    (48, 64, "xla", "bf16 + 3xTF32", "bytes"),
    (48, 64, "pallas", "bf16", "bytes"),
])
def test_k5_cost_at_the_wide_levels(c, hw, form, rate, by):
    """At C = 48 and 192 the f32 form runs every product as 3xTF32, the
    xla one-pass form its tower on bf16 and its folds as 3xTF32; the
    pallas form's products all take bf16 values, at the bf16 rate."""
    px = hw * hw
    cost = k5_cost(c, HID, (hw, hw), _packed(c, form), form)
    n_bytes = 4 * px * (4 * c + HID) + READ_BYTES[c, form]
    assert cost["flops"] == px * (FOLD[c] + TOWER[c])
    assert cost["bytes"] == n_bytes
    if form == "f32":
        t_ops = px * (FOLD[c] + TOWER[c]) / PEAK["3xTF32"]
    elif form == "xla":
        t_ops = (px * TOWER[c] / PEAK["bf16"]
                 + px * FOLD[c] / PEAK["3xTF32"])
    else:
        t_ops = px * (FOLD[c] + TOWER[c]) / PEAK["bf16"]
    assert cost["bound_ms"] == pytest.approx(
        1e3 * max(t_ops, n_bytes / 3.35e12), rel=1e-12)
    assert cost["bound_by"] == by and cost["bound_rate"] == rate


@pytest.mark.parametrize("c,hw,form,bound_ms", [
    # 32^2 x 192: the tower 348.1 MFLOP at 989 TFLOP/s (0.352 us) and the
    # fold 75.5 MFLOP at 67 (1.127 us): 1.479 us, above the bytes' 1.164
    (192, 32, "xla", 1.4788272e-3),
    (192, 32, "f32", 6.3227568e-3),
    # the pallas fold's bf16 values stay at the bf16 rate: the bytes
    (192, 32, "pallas", 1.1637684e-3),
    # 64^2 x 48: 0.377 + 0.282 us, below the bytes' 1.283 us
    (48, 64, "xla", 1.2828275e-3),
])
def test_k5_cost_at_the_simt_rate(c, hw, form, bound_ms):
    """``simt``: the f32-grade products at the f32 SIMT rate, the
    instructions of the kernels at the other widths."""
    cost = k5_cost(c, HID, (hw, hw), _packed(c, form), form, simt=True)
    assert cost["bound_ms"] == pytest.approx(bound_ms, rel=1e-6)


@pytest.mark.parametrize("form", ["xla", "pallas"])
def test_k5_cost_of_a_narrow_one_pass_level(form):
    """At C = 96 (64^2, the 4x flow's level 3) the xla form runs its folds
    as f32 SIMT FMA: the fold's time at 67 TFLOP/s beside the tower's at
    989; the pallas form's fold of bf16 values at 989.  Against the bytes;
    a batch counts as its rows, the buffer read once."""
    packed = _packed(96, form)
    one = k5_cost(96, HID, (64, 64), packed, form)
    fold_rate = {"xla": 67e12, "pallas": 989e12}[form]
    t_ops = 4096 * (TOWER[96] / 989e12 + FOLD[96] / fold_rate)
    read = packed.numel() * 2 - 4 * 96 * 96
    n_bytes = 4 * 4096 * (4 * 96 + HID) + read
    assert one["bytes"] == n_bytes
    assert one["bound_ms"] == pytest.approx(
        1e3 * max(t_ops, n_bytes / 3.35e12), rel=1e-12)
    assert one["bound_rate"] == {"xla": "bf16 + f32 SIMT",
                                 "pallas": "bf16"}[form]
    two = k5_cost(96, HID, (2 * 64, 64), packed, form)
    assert two["flops"] == 2 * one["flops"]
    assert two["bytes"] == 2 * n_bytes - read
    assert torch.bfloat16 == packed.dtype
