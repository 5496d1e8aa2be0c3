"""Port parity: the precision modes of ``bfsr_tpu_torch/ops/nn.py``
(``default`` = bf16 serving, ``mixed`` = the per-stage policy) against
``bfsr_tpu/ops/nn.py``'s, mirroring ``tests/test_precision_mode.py``: the
setter, the env var, the stage policy with nesting, and which twin
``conv3x3_cat``, ``conv2d`` and ``linear`` run in each mode.

Every test that sets a mode restores both packages' modes and policies
(``restore_modes``): under xdist's ``--dist loadfile`` a file shares one
process, so a mode must not leak into the next test.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bfsr_tpu.ops import nn as jnn
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import (conv3x3_cat,
                                             conv3x3_cat_bf16_plain,
                                             conv3x3_cat_plain,
                                             conv3x3_cat_twin,
                                             kernel_weight, kernel_weight_bf16)


@pytest.fixture
def restore_modes():
    saved = (tnn.precision_mode(), dict(tnn.MIXED_POLICY), jnn._MODE,
             dict(jnn.MIXED_POLICY))
    yield
    tnn.set_default_precision(saved[0])
    tnn.MIXED_POLICY.clear()
    tnn.MIXED_POLICY.update(saved[1])
    jnn.set_default_precision(saved[2])
    jnn.MIXED_POLICY.clear()
    jnn.MIXED_POLICY.update(saved[3])


_JAX_NAMES = {jax.lax.Precision.DEFAULT: "default",
              jax.lax.Precision.HIGH: "high",
              jax.lax.Precision.HIGHEST: "highest"}


def test_default_mode_is_high():
    assert tnn.precision_mode() == "high"
    assert tnn.default_precision() == "high" and not tnn.bf16_stage()


def test_setter_roundtrip(restore_modes):
    for name in ("default", "high", "highest"):
        tnn.set_default_precision(name)
        jnn.set_default_precision(name)
        assert tnn.default_precision() == name
        assert tnn.stage_precision() == name
        assert _JAX_NAMES[jnn.default_precision()] == name
    tnn.set_default_precision("mixed")
    assert tnn.precision_mode() == "mixed"
    assert tnn.default_precision() == "high"
    with pytest.raises(ValueError):     # a typo fails loudly
        tnn.set_default_precision("defualt")
    assert tnn.precision_mode() == "mixed"


@pytest.mark.parametrize("env,top,prior", [
    ("default", "default", "default"), ("mixed", "high", "default"),
    ("highest", "highest", "highest")])
def test_env_var_selects_mode(env, top, prior):
    """BFSR_PRECISION is read at import; in a subprocess that cannot
    import jax."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'bfsr_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from bfsr_tpu_torch.ops import nn as fnn\n"
            f"assert fnn.precision_mode() == {env!r}\n"
            f"assert fnn.default_precision() == {top!r}\n"
            "with fnn.stage('prior'):\n"
            f"    assert fnn.default_precision() == {prior!r}\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, BFSR_PRECISION=env),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


def test_env_var_rejects_a_bad_mode():
    out = subprocess.run(
        [sys.executable, "-c", "import bfsr_tpu_torch.ops.nn"],
        env=dict(os.environ, BFSR_PRECISION="defualt"), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and "BFSR_PRECISION" in out.stderr


def test_mixed_stage_policy_nests_like_jax(restore_modes):
    """A two-stage policy, resolved per stage in both packages; nesting
    restores the enclosing stage; non-mixed modes ignore stages."""
    for fnn, lo in ((tnn, "default"), (jnn, jax.lax.Precision.DEFAULT)):
        fnn.set_default_precision("mixed")
        fnn.MIXED_POLICY.clear()
        fnn.MIXED_POLICY.update({"encoder": lo, "prior": lo})

    def both():
        return tnn.default_precision(), _JAX_NAMES[jnn.default_precision()]

    assert both() == ("high", "high")
    with tnn.stage("encoder"), jnn.stage("encoder"):
        assert both() == ("default", "default")
        with tnn.stage("head"), jnn.stage("head"):
            assert both() == ("high", "high")
        assert both() == ("default", "default")
    with tnn.stage("prior"), jnn.stage("prior"):
        assert both() == ("default", "default")
    assert both() == ("high", "high")
    tnn.set_default_precision("high")
    with tnn.stage("encoder"):
        assert tnn.default_precision() == "high"


def test_shipped_mixed_policy_is_the_prior(restore_modes):
    assert tnn.MIXED_POLICY == {"prior": "default"}
    assert {k: _JAX_NAMES[v] for k, v in jnn.MIXED_POLICY.items()} == \
        tnn.MIXED_POLICY
    tnn.set_default_precision("mixed")
    for name in ("encoder", "head", "addback", None):
        with tnn.stage(name):
            assert not tnn.bf16_stage()
    with tnn.stage("prior"):
        assert tnn.bf16_stage()


def test_stage_restores_on_exception(restore_modes):
    tnn.set_default_precision("mixed")
    with tnn.stage("prior"):
        with pytest.raises(KeyError):
            with tnn.stage("head"):
                raise KeyError("inside")
        assert tnn.bf16_stage()
    assert not tnn.bf16_stage()


@pytest.mark.parametrize("sentinel", ["two_pass", "two_pass_act"])
def test_two_pass_policy_value_raises(restore_modes, sentinel):
    """The 2-pass sentinels were refuted on the TPU and are not ported."""
    tnn.set_default_precision("mixed")
    tnn.MIXED_POLICY["cond"] = sentinel
    with tnn.stage("cond"):
        with pytest.raises(NotImplementedError):
            tnn.stage_precision()
        x = torch.zeros((1, 4, 4, 3))
        with pytest.raises(NotImplementedError):
            conv3x3_cat([x], torch.zeros((8, 3, 3, 3)))
    assert tnn.stage_precision() == "high"


def _conv_case(rng, cins=(3, 6, 16), cout=16, hw=(6, 7)):
    xs = [torch.from_numpy(rng.standard_normal((1, *hw, c))
                           .astype(np.float32)) for c in cins]
    w = torch.from_numpy((0.3 * rng.standard_normal((cout, sum(cins), 3, 3)))
                         .astype(np.float32))
    s = torch.from_numpy((rng.random(cout) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return xs, w, s, b


@pytest.mark.parametrize("mode,stage,bf16", [
    ("high", None, False), ("highest", "prior", False),
    ("default", None, True), ("default", "encoder", True),
    ("mixed", None, False), ("mixed", "encoder", False),
    ("mixed", "head", False), ("mixed", "prior", True)])
def test_conv3x3_cat_twin_follows_mode(rng, restore_modes, mode, stage,
                                       bf16):
    xs, w, s, b = _conv_case(rng)
    want = (conv3x3_cat_bf16_plain if bf16 else conv3x3_cat_plain)(
        xs, w, s, b, "lrelu")
    tnn.set_default_precision(mode)
    with tnn.stage(stage):
        got = conv3x3_cat(xs, w, s, b, "lrelu")
        twin = conv3x3_cat_twin(xs, w, s, b, "lrelu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(twin, want, rtol=0, atol=0)


def test_bf16_twin_rounds_operands_once(rng):
    """The bf16 twin equals the f32 twin on pre-rounded operands, and
    differs from the unrounded conv by bf16 rounding (~2^-9 relative)."""
    xs, w, s, b = _conv_case(rng)
    r = tnn.round_bf16
    got = conv3x3_cat_bf16_plain(xs, w, s, b, "relu")
    torch.testing.assert_close(
        got, conv3x3_cat_plain([r(x) for x in xs], r(w), s, b, "relu"),
        rtol=0, atol=0)
    f32 = conv3x3_cat_plain(xs, w, s, b, "relu")
    rel = float((got - f32).abs().max() / f32.abs().max())
    assert 1e-5 < rel < 2e-2, rel
    # rounding is round-to-nearest-even on the bf16 grid
    t = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -2.5e-3])
    assert r(t).tolist() == [1.0, 1.0 + 2.0 ** -6, float(
        torch.tensor(-2.5e-3).to(torch.bfloat16).float())]


@pytest.mark.parametrize("mode,stage,bf16", [
    ("high", None, False), ("default", None, True),
    ("mixed", "prior", True), ("mixed", "head", False)])
def test_conv2d_and_linear_follow_mode(rng, restore_modes, mode, stage,
                                       bf16):
    x = torch.from_numpy(rng.standard_normal((1, 9, 7, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((20, 12, 3, 3)).astype(np.float32))
    lw = torch.from_numpy(rng.standard_normal((5, 12)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    r = tnn.round_bf16 if bf16 else (lambda t: t)
    want_c = F.conv2d(r(x).permute(0, 3, 1, 2), r(w), bias, stride=3,
                      padding=1).permute(0, 2, 3, 1)
    want_l = F.linear(r(x), r(lw))
    tnn.set_default_precision(mode)
    with tnn.stage(stage):
        got_c = tnn.conv2d(x, w, bias, stride=3, padding=1)
        got_l = tnn.linear(x, lw)
    torch.testing.assert_close(got_c, want_c, rtol=0, atol=0)
    torch.testing.assert_close(got_l, want_l, rtol=0, atol=0)


@pytest.mark.parametrize("cin,cout", [(5, 8), (35, 32), (64, 192)])
def test_kernel_weight_bf16_layout(rng, cin, cout):
    """The bf16 kernel's weight: K3's (Cin, 3, 3, Cout) layout rounded to
    bf16, Cout zero-padded to a multiple of 16."""
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3))
                         .astype(np.float32))
    kw = kernel_weight_bf16(w)
    cout_p = -(-cout // 16) * 16
    assert kw.dtype == torch.bfloat16 and kw.is_contiguous()
    assert kw.shape == (cin, 3, 3, cout_p)
    torch.testing.assert_close(kw[..., :cout].float(),
                               tnn.round_bf16(kernel_weight(w)), rtol=0,
                               atol=0)
    assert not kw[..., cout:].any()


def test_freeze_caches_both_kernel_layouts():
    """Every K3 conv of a frozen model keeps the f32 and the bf16 layout,
    so one frozen model serves every mode."""
    from bfsr_tpu_torch.entry import build_flagship

    model, prior = build_flagship("cpu", tiny=True)
    convs = [m for m in (*model.encoder.modules(), *prior.modules())
             if getattr(m, "kweight_bf16", None) is not None]
    assert len(convs) == 6 + 9    # EDSR 2 x 16: 6 convs; UNet: 9 at full res
    for c in convs:
        torch.testing.assert_close(c.kweight_bf16, kernel_weight_bf16(c.weight),
                                   rtol=0, atol=0)


def test_edsr_routes_all_34_convs_through_conv3x3_cat(monkeypatch,
                                                      restore_modes):
    """The flagship encoder (16 blocks): head, 32 block convs and the tail
    all reach ``conv3x3_cat``, so all follow the mode."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.models import edsr

    calls = []
    real = edsr.conv3x3_cat

    def counting(*a, **k):
        calls.append(tnn.bf16_stage())
        return real(*a, **k)

    monkeypatch.setattr(edsr, "conv3x3_cat", counting)
    enc = registry.make({"name": "edsr-baseline",
                         "args": {"no_upsampling": True}}).eval().freeze()
    x = torch.rand((1, 5, 4, 3), generator=torch.Generator().manual_seed(0))
    tnn.set_default_precision("default")
    with torch.no_grad():
        enc(x)
    assert calls == [True] * 34
