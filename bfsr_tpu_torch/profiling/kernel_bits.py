"""Fingerprints of K3 (f32 and bf16), K2 and K5 (f32 and both one-pass
forms) at batch 1 on fixed inputs, to show that two checkouts compute the
same bits.

    PYTHONPATH=<checkout> python bfsr_tpu_torch/profiling/kernel_bits.py \\
        --label <name> [--out chiprun_out/kernel_bits.jsonl]

prints (and appends to ``--out``) one JSON line: per case, the SHA-256 of
the output's bytes.  Run it once per checkout in one call (the parent
unpacked with ``git archive`` into ``_archive/``) and compare the lines.
The cases are the main paths' batch-1 shapes: the encoder's conv at LR
128^2 and 96x80, the prior's dense and ``up`` convs at 512^2, a ragged
16-channel conv; the bf16 K3 at those five and at the RRDB's conv4 (160
-> 32) and conv5 (192 -> 64) at 128^2 and the conv probe's 64 -> 192 at
128^2 (three Cout blocks); K2 at 128^2 -> 512^2 and 96x80 -> 300x250 (out
60) and the patch model's 172^2 grid (out 540); K5 forward and reverse,
f32 and in the ``xla`` and ``pallas`` one-pass forms, at the three flow
levels of a 512^2 image (256^2 x 12, 128^2 x 24, 64^2 x 96) and level 1 of
the ragged 404x340 one (204 x 172 x 12), on a random step's buffers, and
the f32 form at the 8x flow's wide levels (64^2 x 48, 32^2 x 192).  It
uses only ``conv3x3_cat``, ``conv3x3_cat_bf16``, ``affine_info`` with 1-D
grid axes, ``FlowStep`` and the K5 wrappers, so it runs against any
checkout of the port that has the bf16 K3 and both one-pass K5 forms.
"""

import argparse
import hashlib
import json

import numpy as np
import torch

from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import conv3x3, flow_step, linf_info

K3_CASES = [([64], 64, (128, 128)), ([3], 64, (96, 80)),
            ([3, 32, 32, 32, 32], 32, (512, 512)), ([64, 64], 64, (512, 512)),
            ([16, 16], 16, (37, 45))]
K3_BF16_CASES = K3_CASES + [([64, 32, 32, 32], 32, (128, 128)),
                            ([64, 32, 32, 32, 32], 64, (128, 128)),
                            ([64], 192, (128, 128))]
K2_CASES = [(256, 2, 60, (128, 128), (512, 512)),
            (256, 2, 540, (128, 128), (172, 172)),
            (256, 2, 60, (96, 80), (300, 250))]
K5_CASES = [(12, (256, 256)), (24, (128, 128)), (96, (64, 64)),
            (12, (204, 172))]
# the f32 form at the 8x flow's wide levels of a 512^2 sample (64^2 x 48,
# 32^2 x 192), drawn after every case above
K5_WIDE_F32_CASES = [(48, (64, 64)), (192, (32, 32))]


def random_step(g, c, dev, hid=64):
    """A frozen conditional FlowStep with live random weights from the
    numpy generator ``g``, on ``dev``."""
    from bfsr_tpu_torch.models.srflow.flow_upsampler import FlowStep

    step = FlowStep(c, 16, hid)
    with torch.no_grad():
        for name, p in step.named_parameters():
            if name == "invconv.weight":
                q, _ = np.linalg.qr(g.standard_normal((c, c)))
                p.copy_(torch.from_numpy(q))
            elif name.endswith("weight"):
                p.copy_(torch.from_numpy(
                    g.standard_normal(p.shape) / np.sqrt(p[0].numel())))
            else:
                p.copy_(torch.from_numpy(0.1 * g.standard_normal(p.shape)))
    step.to(dev).freeze()
    return step


def fingerprints(dev):
    g = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    def digest(y):
        return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()

    out = {}
    for cins, cout, hw in K3_CASES:
        xs = [t(g.standard_normal((1, *hw, c))) for c in cins]
        w = t(0.2 * g.standard_normal((cout, sum(cins), 3, 3)))
        b, s = t(g.standard_normal(cout)), t(g.random(cout) + 0.5)
        out[f"k3 {cins}->{cout} @{hw}"] = digest(
            conv3x3.conv3x3_cat(xs, w, s, b, "lrelu"))
    for C, n_hidden, out_dim, hw, HW in K2_CASES:
        coef, freq = (t(g.standard_normal((1, *hw, C))) for _ in range(2))
        ys = t((np.arange(HW[0]) * 2 + 1) / HW[0] - 1)
        xs = t((np.arange(HW[1]) * 2 + 1) / HW[1] - 1)
        phase = t(g.standard_normal(C // 2))
        dims = [4 * C] + [C] * (n_hidden + 1) + [out_dim]
        mlp = [(t(g.uniform(-1, 1, (o, i)) / np.sqrt(i)),
                t(0.1 * g.standard_normal(o)))
               for i, o in zip(dims[:-1], dims[1:])]
        out[f"k2 C={C} out={out_dim} {hw}->{HW}"] = digest(
            linf_info.affine_info(coef, freq, ys, xs, phase, mlp))
    # after K2, so the earlier cases draw what they drew before
    for cins, cout, hw in K3_BF16_CASES:
        xs = [t(g.standard_normal((1, *hw, c))) for c in cins]
        w = t(0.2 * g.standard_normal((cout, sum(cins), 3, 3)))
        b, s = t(g.standard_normal(cout)), t(g.random(cout) + 0.5)
        out[f"k3 bf16 {cins}->{cout} @{hw}"] = digest(
            conv3x3.conv3x3_cat_bf16(xs, w, s, b, "lrelu"))
    # after the bf16 K3, so the earlier cases draw what they drew before
    saved = fnn.precision_mode()
    try:
        for c, hw in K5_CASES:
            step = random_step(g, c, dev)
            x = t(g.standard_normal((1, *hw, c)))
            rec = t(np.concatenate([g.uniform(0.6, 1.0, (1, *hw, c)),
                                    0.5 * g.standard_normal((1, *hw, c)),
                                    g.standard_normal((1, *hw, 64))], -1))
            for form in ("f32", "xla", "pallas"):
                pb = None if form == "f32" else flow_step.pack_step_bf16(
                    step.actnorm, step.invconv, step.affine, form)
                fnn.set_default_precision("high" if form == "f32"
                                          else "default")
                for way, fn in (("forward", flow_step.flow_step_forward),
                                ("reverse", flow_step.flow_step_reverse)):
                    y = fn(x, rec, step.kpacked, 64, pb,
                           "xla" if form == "f32" else form)
                    out[f"k5 {form} {way} C={c} @{hw}"] = digest(y)
        fnn.set_default_precision("high")
        for c, hw in K5_WIDE_F32_CASES:
            step = random_step(g, c, dev)
            x = t(g.standard_normal((1, *hw, c)))
            rec = t(np.concatenate([g.uniform(0.6, 1.0, (1, *hw, c)),
                                    0.5 * g.standard_normal((1, *hw, c)),
                                    g.standard_normal((1, *hw, 64))], -1))
            for way, fn in (("forward", flow_step.flow_step_forward),
                            ("reverse", flow_step.flow_step_reverse)):
                out[f"k5 f32 {way} C={c} @{hw}"] = digest(
                    fn(x, rec, step.kpacked, 64))
    finally:
        fnn.set_default_precision(saved)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    line = json.dumps({"label": args.label,
                       "bits": fingerprints(torch.device("cuda"))})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
