"""Training under the bf16 modes (``mixed``, ``default``), on the CPU.

The rule a bf16 stage follows in the backward (``ops/nn.py``): each
backward product of a conv or linear takes bf16-rounded operands, the
incoming gradient among them, and sums in f32, unrounded, as XLA's
transposed ops at ``Precision.DEFAULT`` compute it; the bias's gradient is
the sum of the unrounded incoming gradient.  Checked against float64
references of the products of the rounded operands, for ``conv2d``,
``linear`` and the VGG's convs; in ``high`` the gradients are torch's own,
bit for bit; the forward is bit for bit what it was in every mode.  The
bf16 K3's twin at a batch is its batch-1 calls.  Both trainers (pixel and
patch) under ``mixed`` and ``default`` against the JAX step in the same
mode (a smoke test: on the CPU the JAX side is f32), with their
conv-weight gradients unrounded, which the old rounding cast fails; the
step from its own frozen values; and the trainer CLI for an epoch under
``--precision mixed`` and ``default``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bfsr_tpu import registry as jregistry
from bfsr_tpu.ops import nn as jnn
from bfsr_tpu.pipelines.linf_train import make_train_step as j_make_train_step
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import load_linf, unet_state_dict
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.ops.cuda.conv3x3 import conv3x3_cat_bf16_plain
from bfsr_tpu_torch.pipelines.linf_train import make_train_step
from bfsr_tpu_torch.train.optim import make_optimizer

import test_torch_patch_train as patch_t
import test_torch_train_step as pixel_t
from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_train_parts import _np, small_jax_linf

MODES = [("mixed", "prior"), ("default", None)]
# a float32 sum of bf16 products against float64: relative to the largest
# value
GRAD_RTOL = 1e-6


def _rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _f64_conv_grads(x, w, g, stride, padding):
    """float64 (dx, dw) of F.conv2d at the bf16-rounded x, w and g."""
    xd = tnn.round_bf16(x.detach()).double().requires_grad_(True)
    wd = tnn.round_bf16(w.detach()).double().requires_grad_(True)
    y = F.conv2d(xd, wd, stride=stride, padding=padding)
    return torch.autograd.grad(y, [xd, wd], tnn.round_bf16(g).double())


@pytest.mark.parametrize("stride,padding", [(1, 1), (3, 1)])
def test_conv2d_bf16_backward_is_the_product_of_rounded_operands(
        restore_modes, stride, padding):
    rng = np.random.default_rng(stride)
    x = torch.tensor(rng.standard_normal((2, 11, 13, 6)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((5, 6, 3, 3)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal(5), dtype=torch.float32,
                     requires_grad=True)
    tnn.set_default_precision("default")
    y = tnn.conv2d(x, w, b, stride=stride, padding=padding)
    g = torch.tensor(rng.standard_normal(y.shape), dtype=torch.float32)
    dx, dw, db = torch.autograd.grad(y, [x, w, b], g)
    rx, rw = _f64_conv_grads(tnn.nhwc_to_nchw(x), w, tnn.nhwc_to_nchw(g),
                             stride, padding)
    assert _rel(dx, rx.permute(0, 2, 3, 1)) <= GRAD_RTOL
    assert _rel(dw, rw) <= GRAD_RTOL
    assert _rel(db, g.double().sum((0, 1, 2))) <= GRAD_RTOL
    # the incoming gradient is rounded: the unrounded one gives other values
    assert not torch.equal(dw, torch.autograd.grad(
        tnn.conv2d(x, w, b, stride=stride, padding=padding), w,
        tnn.round_bf16(g) + 2.0 ** -12 * g.sign())[0])


def test_linear_bf16_backward_is_the_product_of_rounded_operands(
        restore_modes):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((3, 4, 7)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((6, 7)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal(6), dtype=torch.float32,
                     requires_grad=True)
    tnn.set_default_precision("mixed")
    with tnn.stage("prior"):
        y = tnn.linear(x, w, b)
    g = torch.tensor(rng.standard_normal(y.shape), dtype=torch.float32)
    dx, dw, db = torch.autograd.grad(y, [x, w, b], g)
    r = {k: tnn.round_bf16(v.detach()).double() for k, v in
         (("x", x), ("w", w), ("g", g))}
    assert _rel(dx, r["g"] @ r["w"]) <= GRAD_RTOL
    assert _rel(dw, r["g"].reshape(-1, 6).T @ r["x"].reshape(-1, 7)) \
        <= GRAD_RTOL
    assert _rel(db, g.double().reshape(-1, 6).sum(0)) <= GRAD_RTOL


def test_vgg_conv_bf16_backward_is_the_product_of_rounded_operands(
        restore_modes):
    """The VGG's first conv (``feature_layer`` 0) under ``default``: the
    gradient with respect to its [0, 1] input, through the ImageNet
    normalisation, in float64 from the rounded operands."""
    vgg = registry.make({"name": "VGGFeatureExtractor",
                         "args": {"feature_layer": 0}}).requires_grad_(False)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random((2, 9, 10, 3)), dtype=torch.float32,
                     requires_grad=True)
    tnn.set_default_precision("default")
    y = vgg(x)
    g = torch.tensor(rng.standard_normal(y.shape), dtype=torch.float32)
    (dx,) = torch.autograd.grad(y, x, g)
    xn = tnn.nhwc_to_nchw((x.detach() - vgg.mean) / vgg.std)
    rx, _ = _f64_conv_grads(xn, vgg.features[0].weight, tnn.nhwc_to_nchw(g),
                            1, 1)
    assert _rel(dx, rx.permute(0, 2, 3, 1) / vgg.std.double()) <= GRAD_RTOL


def _three_ops(mode_stage, rng):
    """(conv2d, linear, VGG) outputs and gradients, each beside the plain
    torch op on the operands as the mode takes them (rounded in a bf16
    stage)."""
    mode, stage = mode_stage
    tnn.set_default_precision(mode)
    x = torch.tensor(rng.standard_normal((2, 8, 9, 4)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((3, 4, 3, 3)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal(3), dtype=torch.float32,
                     requires_grad=True)
    lw = torch.tensor(rng.standard_normal((5, 4)), dtype=torch.float32,
                      requires_grad=True)
    vgg = registry.make({"name": "VGGFeatureExtractor",
                         "args": {"feature_layer": 3}})
    img = torch.tensor(rng.random((2, 8, 8, 3)), dtype=torch.float32,
                       requires_grad=True)
    with tnn.stage(stage):
        ours = [tnn.conv2d(x, w, b), tnn.linear(x, lw, b[:1].expand(5)),
                vgg(img)]
        rnd = tnn.round_bf16 if tnn.bf16_stage() else (lambda t: t)
    plain_vgg = tnn.nhwc_to_nchw((img - vgg.mean) / vgg.std)
    for i in (0, 2):
        m = vgg.features[i]
        plain_vgg = F.conv2d(rnd(plain_vgg), rnd(m.weight), m.bias,
                             padding=1)
        plain_vgg = torch.relu(plain_vgg) if i == 0 else plain_vgg
    plain = [tnn.nchw_to_nhwc(F.conv2d(tnn.nhwc_to_nchw(rnd(x)), rnd(w), b,
                                       padding=1)),
             F.linear(rnd(x), rnd(lw), b[:1].expand(5)),
             tnn.nchw_to_nhwc(torch.relu(plain_vgg))]
    return ours, plain, [x, w, b, lw, img, vgg.features[0].weight]


@pytest.mark.parametrize("mode_stage", [("high", None), *MODES])
def test_forward_is_bitwise_unchanged_in_every_mode(restore_modes,
                                                    mode_stage):
    ours, plain, _ = _three_ops(mode_stage, np.random.default_rng(2))
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def test_high_gradients_are_torchs_own(restore_modes):
    ours, plain, leaves = _three_ops(("high", None),
                                     np.random.default_rng(3))
    for a, b in zip(ours, plain):
        g = torch.ones_like(a)
        ga = torch.autograd.grad(a, leaves, g, allow_unused=True)
        gb = torch.autograd.grad(b, leaves, g, allow_unused=True)
        for u, v in zip(ga, gb):
            assert (u is None) == (v is None)
            if u is not None:
                assert torch.equal(u, v)


def test_bf16_k3_twin_at_a_batch_is_its_batch_1_calls():
    rng = np.random.default_rng(4)
    xs = [torch.tensor(rng.standard_normal((3, 10, 12, c)),
                       dtype=torch.float32) for c in (3, 16)]
    w = torch.tensor(rng.standard_normal((16, 19, 3, 3)), dtype=torch.float32)
    s = torch.tensor(rng.random(16) + 0.5, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(16), dtype=torch.float32)
    got = conv3x3_cat_bf16_plain(xs, w, s, b, "lrelu")
    for i in range(3):
        one = conv3x3_cat_bf16_plain([x[i:i + 1] for x in xs], w, s, b,
                                     "lrelu")
        assert torch.equal(got[i:i + 1], one), i


def _global_rel_l2(grads, ref):
    g = torch.cat([grads[k].flatten() for k in grads])
    r = torch.cat([ref[k].flatten() for k in grads])
    return float((g - r).norm() / r.norm())


def _trainer(kind):
    """(JAX models and batch, the port's models) of the tiny pixel or
    patch trainer, on the same weights."""
    if kind == "pixel":
        jm = small_jax_linf()
        jprior, jvgg = (jregistry.make(pixel_t.UNET),
                        jregistry.make(pixel_t.VGG))
        return (jm, jprior, jvgg, pixel_t.batch()), pixel_t.port_trainer(
            jm, jprior, jvgg)
    jm = patch_t.small_jax_patch()
    jprior, jvgg = jregistry.make(patch_t.UNET), jregistry.make(patch_t.VGG)
    models = (jm, load_linf(registry.make(patch_t.LINF_PATCH),
                            _np(jm.params)))
    return ((jm, jprior, jvgg, patch_t.patch_batch()),
            patch_t.port_patch_trainer(models, jprior, jvgg))


# On the CPU XLA computes DEFAULT in f32, so the JAX step below is f32
# throughout and these limits are those of bf16 rounding against f32: a
# smoke test, which the old rule (a rounding cast under autograd) passes
# as well.  The backward rule rests on the float64 tests above and on
# BF16_VALUED_SHARE below.
# The loss under a bf16 mode against the f32 loss: its operands carry a
# relative error of at most 2^-9 each; 2^-8 of the loss allows twice that
MODE_LOSS_RTOL = 2.0 ** -8
# the gradients against JAX's: a multiple of the f32 step's own spread in
# the same test under a bf16-sized change of its input (the LR scaled by
# 1 + 2^-9, half a bf16 ulp).  A mode rounds every operand of every conv,
# not one input coherently; MODE_SPREAD_FACTOR allows for that.
MODE_SPREAD_FACTOR = 4.0
# the share of the prior's conv-weight gradient elements that are bf16
# values: an f32 sum of products is one only by chance (0.001 measured),
# a gradient rounded on its way back always is (1.0)
BF16_VALUED_SHARE = 0.5


def _bf16_valued_share(grads):
    ws = [g for g in grads.values() if g.dim() == 4]
    return sum(float((tnn.round_bf16(g) == g).float().mean())
               for g in ws) / len(ws)


def _old_cast(op, x, weight, bias, dims):
    """The rule before the repair: a rounding cast under autograd, which
    also rounds every gradient that passes it."""
    return op(tnn.round_bf16(x), tnn.round_bf16(weight), bias)


@pytest.mark.parametrize("mode_stage", MODES)
@pytest.mark.parametrize("kind", ["pixel", "patch"])
def test_trainer_in_a_bf16_mode_matches_jax(restore_modes, kind, mode_stage):
    mode = mode_stage[0]
    (jm, jprior, jvgg, data), (linf, prior, vgg) = _trainer(kind)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    step = make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                           data_norm=pixel_t.NORM)
    high, high_grads, _ = step.loss_and_grads(data)
    nudged = dict(data, inp=data["inp"] * (1 + 2.0 ** -9))
    spread = _global_rel_l2(step.loss_and_grads(nudged)[1], high_grads)

    jnn.set_default_precision(mode)
    tnn.set_default_precision(mode)
    jstep = j_make_train_step(jm, jprior, jvgg, pixel_t.grad_capture(),
                              latent_weight=1.0, data_norm=pixel_t.NORM,
                              patch=kind == "patch")
    _, jgrads, jmets = jstep(jprior.params,
                             pixel_t.grad_capture().init(jprior.params),
                             jm.params, jvgg.params,
                             {k: jnp.asarray(v) for k, v in data.items()})
    mets, grads, _ = step.loss_and_grads(data)
    ref = {k: v for k, v in unet_state_dict(_np(jgrads)).items()
           if k in grads}
    loss, jloss = float(mets["loss"]), float(jmets["loss"])
    assert abs(loss - jloss) <= MODE_LOSS_RTOL * abs(jloss)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert _global_rel_l2(grads, ref) <= MODE_SPREAD_FACTOR * spread
    assert _bf16_valued_share(grads) < BF16_VALUED_SHARE
    # the mode did round: the loss and the gradients left high's
    assert loss != float(high["loss"])
    assert _global_rel_l2(grads, high_grads) > 1e-4


@pytest.mark.parametrize("mode_stage", MODES)
@pytest.mark.parametrize("kind", ["pixel", "patch"])
def test_the_trainer_check_rejects_a_rounding_cast(restore_modes, monkeypatch,
                                                   kind, mode_stage):
    """The step under the old rule, with everything else as above: its
    conv-weight gradients are all bf16 values, which the check above
    rejects."""
    _, (linf, prior, vgg) = _trainer(kind)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    step = make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                           data_norm=pixel_t.NORM)
    data = pixel_t.batch() if kind == "pixel" else patch_t.patch_batch()
    tnn.set_default_precision(mode_stage[0])
    monkeypatch.setattr(tnn, "_bf16_product", _old_cast)
    _, grads, _ = step.loss_and_grads(data)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert not _bf16_valued_share(grads) < BF16_VALUED_SHARE


@pytest.mark.parametrize("mode", ["high", "mixed", "default"])
def test_the_step_from_its_frozen_values_is_the_step(restore_modes, mode):
    """``loss_and_grads(batch, frozen=step.frozen(batch))``, which
    chip_smoke.py holds in the bf16 modes, is the step bit for bit; the
    encoder's ``conv`` hook with the twin is the twin path's encoder."""
    from bfsr_tpu_torch.ops.cuda.conv3x3 import conv3x3_cat_twin

    _, (linf, prior, vgg) = _trainer("patch")
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    step = make_train_step(linf, prior, vgg, opt, latent_weight=1.0,
                           data_norm=pixel_t.NORM)
    data = patch_t.patch_batch()
    tnn.set_default_precision(mode)
    mets, grads, _ = step.loss_and_grads(data)
    fz = step.frozen(data)
    fmets, fgrads, _ = step.loss_and_grads(data, frozen=fz)
    assert torch.equal(mets["loss"], fmets["loss"])
    for k in grads:
        assert torch.equal(grads[k], fgrads[k]), k
    hooked = linf.encoder(fz["inp"], conv=lambda t, m, act: conv3x3_cat_twin(
        [t], m.weight, bias=m.bias, act=act))
    assert torch.equal(hooked, linf.gen_feat(fz["inp"], kernels=False))


@pytest.mark.parametrize("mode", ["mixed", "default"])
def test_cli_trains_an_epoch_in_a_bf16_mode(tmp_path, monkeypatch,
                                            restore_modes, mode):
    pytest.importorskip("PIL")
    yaml = pytest.importorskip("yaml")
    from bfsr_tpu_torch.cli import train as cli
    from bfsr_tpu_torch.train import checkpoints as ckpt

    from test_torch_train_data import _config, _write_pngs

    root = str(tmp_path / "imgs")
    _write_pngs(root)
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config(root, 1)))
    cli.cli(["--config", str(cfg), "--name", "run", "--precision", mode,
             "--allow_random_vgg", "--device", "cpu"])
    assert tnn.precision_mode() == mode
    sv = ckpt.load_checkpoint(str(tmp_path / "save" / "run"
                                  / "prior_model-epoch-last.ckpt"))
    assert sv["epoch"] == 1
    assert sv["optimizer"]["sd"]["state"][0]["step"] == 2
    for p in sv["prior_model"]["sd"].values():
        assert torch.isfinite(p.float()).all()
