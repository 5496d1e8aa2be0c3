"""Port parity for the SRFlow-LP prior trainer's parts, on the CPU (the
twins), against the JAX package where it has the part: K5's twins at a
batch against their batch-1 calls, ``FlowStepReverse``'s gradient against
autograd through the twin and the unfused step, the per-sample
standardisation, the prior's training form and its running-stat update,
the actnorm priming, the ``lrhr-pkl`` dataset and the checkpoint
pruning."""

import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from bfsr_tpu import registry as jregistry
from bfsr_tpu.data.pkl_dataset import LRHRPkl as JLRHRPkl
from bfsr_tpu.models.srflow.unet_prior import srflow_unet_apply
from bfsr_tpu.models.unet import apply_bn_updates as j_apply_bn_updates
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import (load_srflow, load_srflow_unet,
                                             srflow_state_dict,
                                             srflow_unet_state_dict)
from bfsr_tpu_torch.data.pkl_dataset import LRHRPkl
from bfsr_tpu_torch.entry import srflow_specs
from bfsr_tpu_torch.models.srflow.flow_upsampler import FlowStep
from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
from bfsr_tpu_torch.ops import nn as tnn
from bfsr_tpu_torch.ops.cuda import flow_step as k5
from bfsr_tpu_torch.train import checkpoints as ckpt

import bfsr_tpu.models  # noqa: F401  (registers the JAX components)
from test_torch_precision import restore_modes  # noqa: F401  (fixture)
from test_torch_srflow_models import _np_tree, _prior_params, live_flow


def random_step(c, hid=64, c_cond=16, seed=0):
    """A frozen conditional FlowStep with live random weights (nonzero
    actnorms and Conv2dZeros tails); its records are drawn apart."""
    g = np.random.default_rng(seed)
    step = FlowStep(c, c_cond, hid)
    with torch.no_grad():
        for name, t in step.named_parameters():
            if name == "invconv.weight":
                q, _ = np.linalg.qr(g.standard_normal((c, c)))
                t.copy_(torch.from_numpy(q))
            elif name.endswith("weight"):
                t.copy_(torch.from_numpy(
                    g.standard_normal(t.shape) / np.sqrt(t[0].numel())))
            else:
                t.copy_(torch.from_numpy(0.1 * g.standard_normal(t.shape)))
    step.freeze()
    return step


def records(b, hw, c, hid=64, seed=1):
    """(B, H, W, 2C + hid) records [scale_ft in (0.6, 1) | shift_ft |
    aff1_ft]."""
    g = np.random.default_rng(seed)
    return torch.tensor(np.concatenate(
        [g.uniform(0.6, 1.0, (b, *hw, c)), 0.5 * g.standard_normal((b, *hw, c)),
         g.standard_normal((b, *hw, hid))], -1), dtype=torch.float32)


# (form, forward twin, reverse twin); None: f32
TWINS = [(None, k5.flow_step_forward_plain, k5.flow_step_reverse_plain),
         ("xla", k5.flow_step_forward_bf16_plain,
          k5.flow_step_reverse_bf16_plain),
         ("pallas", k5.flow_step_forward_bf16_pallas_plain,
          k5.flow_step_reverse_bf16_pallas_plain)]


@pytest.mark.parametrize("c", [12, 24, 96])
@pytest.mark.parametrize("form,fwd,rev", TWINS)
def test_batched_k5_twin_is_its_batch_1_calls(c, form, fwd, rev):
    step = random_step(c, seed=c)
    packed = step.kpacked if form is None else k5.pack_step_bf16(
        step.actnorm, step.invconv, step.affine, form)
    x = torch.tensor(np.random.default_rng(c).standard_normal((3, 6, 5, c)),
                     dtype=torch.float32)
    rec = records(3, (6, 5), c)
    for fn in (fwd, rev):
        got = fn(x, rec, packed, 64)
        for i in range(3):
            assert torch.equal(got[i:i + 1],
                               fn(x[i:i + 1], rec[i:i + 1], packed, 64)), i


def test_k5_wrapper_takes_a_batch_and_checks_its_records():
    step = random_step(12)
    x = torch.zeros((2, 4, 4, 12))
    with pytest.raises(ValueError):   # one record per image
        k5.flow_step_forward(x, records(1, (4, 4), 12), step.kpacked, 64)
    assert k5.flow_step_forward(x, records(2, (4, 4), 12), step.kpacked,
                                64).shape == (2, 4, 4, 12)


def _grad(fn, x, up):
    xr = x.clone().requires_grad_(True)
    return torch.autograd.grad(fn(xr), xr, up)[0]


@pytest.mark.parametrize("c", [12, 24, 96])
def test_flow_step_reverse_gradient_is_the_twins(restore_modes, c):
    """FlowStepReverse differentiates the twin the batch at once.  f32: its
    gradient is autograd's through the twin's batch form bit for bit, and
    through the twin itself (image by image) to f32 roundoff.  The served
    one-pass form: autograd's through the unfused step under default (the
    convs through ``fnn.conv2d``, whose backward is a bf16 stage's) within
    1e-4 relative L2: the two order their f32 sums differently, which
    flips a bf16 rounding at a tie here and there (0 to 3.6e-6 measured).
    The twin with a plain rounding under autograd, which also rounds the
    gradient, is 7e-4 to 1.4e-3 off it: more than twice the limit.  The
    forward's values are the twin's in either form."""
    step = random_step(c, seed=c)
    g = np.random.default_rng(c + 1)
    x = torch.tensor(g.standard_normal((2, 9, 7, c)), dtype=torch.float32)
    up = torch.tensor(g.standard_normal((2, 9, 7, c)), dtype=torch.float32)
    rec = records(2, (9, 7), c)
    tnn.set_default_precision("high")
    got = _grad(lambda t: k5.flow_step_reverse_diff(t, rec, step.kpacked, 64),
                x, up)
    p = k5.unpack_step(step.kpacked, c, 64)
    assert torch.equal(got, _grad(lambda t: k5._reverse_batch(t, rec, p), x,
                                  up))
    ref = _grad(lambda t: k5.flow_step_reverse_plain(t, rec, step.kpacked,
                                                     64), x, up)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    assert torch.equal(k5.flow_step_reverse_diff(x, rec, step.kpacked, 64),
                       k5.flow_step_reverse_plain(x, rec, step.kpacked, 64))
    tnn.set_default_precision("default")
    pb = step.kpacked_bf16
    for xi, ri, ui in ((x, rec, up), (x[:1], rec[:1], up[:1]),
                       (x[1:], rec[1:], up[1:])):
        one = _grad(lambda t: k5.flow_step_reverse_diff(t, ri, step.kpacked,
                                                        64, pb), xi, ui)
        ref = _grad(lambda t: step.reverse_step(t, ri, kernels=False), xi, ui)
        old = _grad(lambda t: k5.flow_step_reverse_bf16_plain(t, ri, pb, 64),
                    xi, ui)
        assert float((one - ref).norm() / ref.norm()) <= 1e-4
        assert float((old - ref).norm() / ref.norm()) > 2e-4
    assert torch.equal(k5.flow_step_reverse_diff(x, rec, step.kpacked, 64, pb),
                       k5.flow_step_reverse_bf16_plain(x, rec, pb, 64))


def test_flow_step_reverse_reads_the_form_at_the_call(restore_modes):
    """The backward differentiates the form the forward ran in, whatever
    the mode when the backward runs (the pallas form here)."""
    step = random_step(24, seed=3)
    pb = k5.pack_step_bf16(step.actnorm, step.invconv, step.affine, "pallas")
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 5, 6, 24)),
                     dtype=torch.float32, requires_grad=True)
    rec = records(2, (5, 6), 24)
    tnn.set_default_precision("default")
    y = k5.flow_step_reverse_diff(x, rec, step.kpacked, 64, pb, "pallas")
    assert torch.equal(y.detach(), k5.flow_step_reverse_bf16_pallas_plain(
        x.detach(), rec, pb, 64))
    tnn.set_default_precision("high")
    (got,) = torch.autograd.grad(y.sum(), x)
    tnn.set_default_precision("default")
    assert torch.equal(got, _grad(lambda t: k5.flow_step_reverse_twin(
        t, rec, step.kpacked, 64, pb, "pallas").sum(), x.detach(), None))


def test_standardize_epses_is_per_sample(rng):
    es = [torch.tensor(rng.standard_normal((3, 4, 5, c)), dtype=torch.float32)
          for c in (6, 96)]
    got = standardize_epses(es)
    for i in range(3):
        one = standardize_epses([e[i:i + 1] for e in es])
        for g, o in zip(got, one):
            assert torch.equal(g[i:i + 1], o)


def _tiny_prior():
    """(JAX two-branch prior with perturbed BN stats, the port's on its
    weights, in train mode)."""
    _, ps = srflow_specs(tiny=True)
    jp = jregistry.make(ps)
    jp.params = _prior_params(jp.params)
    tp = load_srflow_unet(registry.make(ps), _np_tree(jp.params)).train()
    return jp, tp


def test_prior_training_form_matches_jax(rng):
    """``forward(epses, training=True)`` and ``apply_bn_updates`` against
    ``srflow_unet_apply(..., training=True)`` and JAX's update."""
    jp, tp = _tiny_prior()
    e0 = rng.standard_normal((2, 12, 10, 6)).astype(np.float32)
    e1 = rng.standard_normal((2, 4, 6, 96)).astype(np.float32)
    ref, stats = srflow_unet_apply(jp.params, [jnp.asarray(e0),
                                               jnp.asarray(e1)], depth=2,
                                   training=True)
    got, bn_stats = tp([torch.from_numpy(e0), torch.from_numpy(e1)],
                       training=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=5e-5, rtol=5e-5)
    # per branch: inc, 2 downs and 2 ups, 2 BatchNorms each
    assert len(bn_stats) == len(stats) == 2 * (1 + 2 + 2) * 2
    tp.apply_bn_updates(bn_stats)
    want = srflow_unet_state_dict(_np_tree(j_apply_bn_updates(jp.params,
                                                              stats)))
    for name, t in tp.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       atol=1e-6, err_msg=name)


def _unprimed_pair():
    """The tiny JAX SRFlowNet with live tails and the reference's zero
    step actnorms, and the port's on the same weights."""
    fs, _ = srflow_specs(tiny=True)
    jm = jregistry.make(fs)
    params = live_flow(jm.params)
    layers = []
    for p in params["flow"]["layers"]:
        p = dict(p)
        if "actnorm" in p:
            p["actnorm"] = {k: jnp.zeros_like(v)
                            for k, v in p["actnorm"].items()}
        layers.append(p)
    jm.params = dict(params, flow={"layers": layers})
    tm = load_srflow(registry.make(fs), _np_tree(jm.params)).eval()
    return jm, tm


def test_prime_actnorms_matches_jax(rng):
    jm, tm = _unprimed_pair()
    gt = rng.random((2, 16, 24, 3)).astype(np.float32)
    lq = rng.random((2, 4, 6, 3)).astype(np.float32)
    assert tm.flowUpsamplerNet.actnorms_unprimed()
    primed = jm.prime_actnorms(jm.params, jnp.asarray(gt), jnp.asarray(lq))
    old = [s.kpacked.clone() for s in tm.flowUpsamplerNet.steps()
           if s.affine is not None]
    tm.prime_actnorms(torch.from_numpy(gt), torch.from_numpy(lq))
    assert not tm.flowUpsamplerNet.actnorms_unprimed()
    want = srflow_state_dict(_np_tree(primed), tm.plan)
    got = tm.state_dict()
    names = [k for k in want if ".actnorm." in k and "affine" not in k]
    assert len(names) == 2 * 3 * (2 + 2)
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
        assert float(got[k].abs().max()) > 0, k
    # priming re-froze the flow: the K5 buffers hold the primed actnorms
    new = [s for s in tm.flowUpsamplerNet.steps() if s.affine is not None]
    for s, o in zip(new, old):
        assert torch.equal(s.kpacked, k5.pack_step(s.actnorm, s.invconv,
                                                   s.affine))
        assert not torch.equal(s.kpacked, o)


def _write_pairs(tmp_path, rng, n=5):
    hrs = [(rng.random((24 + 4 * i, 32, 3)) * 255).astype(np.uint8)
           for i in range(n)]
    lqs = [(rng.random((6 + i, 8, 3)) * 255).astype(np.uint8)
           for i in range(n)]
    paths = []
    for name, data in (("gt.pklv4", hrs), ("lq.pklv4", lqs)):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            pickle.dump(data, f)
        paths.append(p)
    return paths


@pytest.mark.parametrize("use_flip,gt_size,n_max", [(True, 16, None),
                                                   (False, None, 3),
                                                   (True, 28, 4)])
def test_lrhr_pkl_matches_jax(tmp_path, rng, use_flip, gt_size, n_max):
    gt_p, lq_p = _write_pairs(tmp_path, rng)
    args = dict(dataroot_GT=gt_p, dataroot_LQ=lq_p, use_flip=use_flip,
                n_max=n_max, gt_size=gt_size)
    ours, ref = LRHRPkl(**args), JLRHRPkl(**args)
    assert len(ours) == len(ref) == (n_max or 5)
    random.seed(7)
    want = [ref[i] for i in range(len(ref)) for _ in range(3)]
    random.seed(7)
    got = [ours[i] for i in range(len(ours)) for _ in range(3)]
    for g, w in zip(got, want):
        for k in ("GT", "LQ"):
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])
    assert registry.make({"name": "lrhr-pkl", "args": args}).gt_size == \
        gt_size


def test_keep_newest_and_auto_resume_by_prefix(tmp_path):
    for i, name in enumerate(["prior_3.ckpt", "prior_5.ckpt", "other.ckpt",
                              "prior_7.ckpt"]):
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (1000 + i, 1000 + i))
    d = str(tmp_path)
    assert ckpt.find_auto_resume(d, prefix="prior_").endswith("prior_7.ckpt")
    ckpt.keep_newest(d, "prior_", 2)
    assert sorted(os.listdir(d)) == ["other.ckpt", "prior_5.ckpt",
                                     "prior_7.ckpt"]
    assert ckpt.find_auto_resume(str(tmp_path / "missing")) is None


def test_jax_and_torch_stay_on_the_cpu():
    assert jax.default_backend() == "cpu"
