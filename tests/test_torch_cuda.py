"""The port's CUDA kernels on the card: each kernel against its plain twin
and a float64 CPU reference, at small shapes.  Marked ``cuda``; they skip
without a GPU.  This file imports no jax, so it also runs where jax is
absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bfsr_tpu_torch.ops import cuda as kcuda
from bfsr_tpu_torch.ops.cuda import conv3x3, flow_step, linf_flow, linf_info

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gen(seed=0):
    return np.random.default_rng(seed)


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                           device=dev)


@pytest.mark.parametrize("n_layers,n", [(3, 1000), (10, 4099), (12, 257)])
def test_k1_matches_twin_and_float64(dev, n_layers, n):
    g = _gen(n_layers)
    w = g.uniform(-1, 1, (n_layers + 1, 3, 3)) / np.sqrt(8) + np.eye(3)
    b = 0.1 * g.standard_normal((n_layers + 1, 3))
    x = g.standard_normal((n, 3))
    info = 0.5 * g.standard_normal((6 * n_layers, n))
    w_inv = np.linalg.inv(w)
    wt, bt, xt, it = (_t(a, dev) for a in (w, b, x, info))
    before = dict(kcuda.LAUNCHES)
    z = linf_flow.flow_forward(wt, bt, xt, it)
    xr = linf_flow.flow_inverse(_t(w_inv, dev), bt, z, it)
    assert kcuda.LAUNCHES["linf_flow_forward"] == before["linf_flow_forward"] + 1
    assert kcuda.LAUNCHES["linf_flow_inverse"] == before["linf_flow_inverse"] + 1
    z64 = linf_flow.flow_forward_plain(*(torch.from_numpy(a) for a in
                                         (w, b, x, info)))
    torch.testing.assert_close(
        z, linf_flow.flow_forward_plain(wt, bt, xt, it), rtol=0, atol=1e-5)
    np.testing.assert_allclose(z.cpu().numpy(), z64.numpy(), atol=1e-5)
    np.testing.assert_allclose(xr.cpu().numpy(), x, atol=1e-4)


def _k4_case(d, n_layers, n):
    """Random K4 weights (W near the identity, its float64 inverse), x and
    info, as numpy arrays.  Past 10 layers the info's spread shrinks as
    1 / sqrt(L): at 0.5 the f32 round trip of 34 layers itself (the plain
    twin's) strays 3e-4 from x, past the 2e-4 that holds the kernel."""
    g = _gen(d + n_layers)
    w = 0.05 * g.uniform(-1, 1, (n_layers + 1, d, d)) / np.sqrt(8) + np.eye(d)
    b = 0.1 * g.standard_normal((n_layers + 1, d))
    x = g.standard_normal((n, d))
    spread = 0.5 * np.sqrt(10 / max(n_layers, 10))
    info = spread * g.standard_normal((2 * d * n_layers, n))
    return w, b, x, info, np.linalg.inv(w)


def _check_k4(dev, d, n_layers, n):
    """K4 forward and inverse against their twins and float64."""
    w, b, x, info, w_inv = _k4_case(d, n_layers, n)
    wt, bt, xt, it = (_t(a, dev) for a in (w, b, x, info))
    before = dict(kcuda.LAUNCHES)
    z = linf_flow.flow_forward(wt, bt, xt, it)
    xr = linf_flow.flow_inverse(_t(w_inv, dev), bt, z, it)
    for k in ("linf_flow_nd_forward", "linf_flow_nd_inverse"):
        assert kcuda.LAUNCHES[k] == before[k] + 1, k
    assert kcuda.LAUNCHES["linf_flow_forward"] == before["linf_flow_forward"]
    torch.testing.assert_close(
        z, linf_flow.flow_forward_plain(wt, bt, xt, it), rtol=0, atol=2e-5)
    torch.testing.assert_close(
        xr, linf_flow.flow_inverse_plain(_t(w_inv, dev), bt, z, it), rtol=0,
        atol=2e-4)
    z64 = linf_flow.flow_forward_plain(*(torch.from_numpy(a) for a in
                                         (w, b, x, info)))
    np.testing.assert_allclose(z.cpu().numpy(), z64.numpy(), atol=2e-5)
    x64 = linf_flow.flow_inverse_plain(
        torch.from_numpy(w_inv), torch.from_numpy(b), z.cpu().double(),
        torch.from_numpy(info))
    np.testing.assert_allclose(xr.cpu().numpy(), x64.numpy(), atol=2e-4)
    np.testing.assert_allclose(xr.cpu().numpy(), x, atol=2e-4)


@pytest.mark.parametrize("d", [12, 27, 48])
@pytest.mark.parametrize("n_layers", [1, 10])
@pytest.mark.parametrize("n", [1, 31, 29591])
def test_k4_matches_twin_and_float64(dev, d, n_layers, n):
    _check_k4(dev, d, n_layers, n)


@pytest.mark.parametrize("d,n_layers,n", [
    (27, 10, 15390),    # the 135 x 114 grid: info rows not 16-B aligned
    (27, 10, 29584),    # the 172^2 grid: the 16-B copies
    (12, 0, 31), (27, 0, 1000), (48, 0, 4099),   # no coupling layer
    (48, 24, 4099),     # a 235 KB stack, many turns of the ring
    (12, 33, 257),      # the deepest stack, at the narrow tile
])
def test_k4_edges_match_twin_and_float64(dev, d, n_layers, n):
    _check_k4(dev, d, n_layers, n)


@pytest.mark.parametrize("d,n", [(12, 4096), (27, 15390), (48, 1000)])
def test_k4_launches_are_bitwise_repeatable(dev, d, n):
    w, b, x, info, w_inv = _k4_case(d, 10, n)
    wt, bt, xt, it, wit = (_t(a, dev) for a in (w, b, x, info, w_inv))
    z1 = linf_flow.flow_forward(wt, bt, xt, it)
    z2 = linf_flow.flow_forward(wt, bt, xt, it)
    x1 = linf_flow.flow_inverse(wit, bt, z1, it)
    x2 = linf_flow.flow_inverse(wit, bt, z1, it)
    assert torch.equal(z1, z2) and torch.equal(x1, x2)


@pytest.mark.parametrize("d", [12, 27, 48])
def test_k4_takes_info_at_any_4_byte_offset(dev, d):
    """A contiguous info view whose base is not 16-B aligned (a slice of a
    larger buffer) gives the same bits as an aligned copy."""
    n_layers, n = 10, 172 * 172
    w, b, x, info, w_inv = _k4_case(d, n_layers, n)
    wt, bt, xt, it, wit = (_t(a, dev) for a in (w, b, x, info, w_inv))
    buf = torch.empty(info.size + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view(info.shape)
    view.copy_(it)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    z = linf_flow.flow_forward(wt, bt, xt, view)
    xr = linf_flow.flow_inverse(wit, bt, z, view)
    assert torch.equal(z, linf_flow.flow_forward(wt, bt, xt, it))
    assert torch.equal(xr, linf_flow.flow_inverse(wit, bt, z, it))
    torch.testing.assert_close(
        z, linf_flow.flow_forward_plain(wt, bt, xt, it), rtol=0, atol=2e-5)
    torch.testing.assert_close(
        xr, linf_flow.flow_inverse_plain(wit, bt, z, it), rtol=0, atol=2e-4)


# queries a K2 block owns (csrc/linf_info.cu, TileFor)
K2_BLOCK = 128


def _k2_case(C, n_hidden, out_dim, hw, HW, dev):
    """(numpy arrays, their CUDA tensors, mlp as numpy and as CUDA tensors)
    of a random K2 problem."""
    g = _gen(C + out_dim)
    h, w = hw
    coef = g.standard_normal((1, h, w, C))
    freq = g.standard_normal((1, h, w, C))
    ys = (np.arange(HW[0]) * 2 + 1) / HW[0] - 1
    xs = (np.arange(HW[1]) * 2 + 1) / HW[1] - 1
    phase = g.standard_normal(C // 2)
    dims = [4 * C] + [C] * (n_hidden + 1) + [out_dim]
    mlp = [(g.uniform(-1, 1, (o, i)) / np.sqrt(i), 0.1 * g.standard_normal(o))
           for i, o in zip(dims[:-1], dims[1:])]
    arrays = (coef, freq, ys, xs, phase)
    return (arrays, [_t(a, dev) for a in arrays], mlp,
            [(_t(wl, dev), _t(bl, dev)) for wl, bl in mlp])


@pytest.mark.parametrize("C,n_hidden,out_dim,hw,HW", [
    (256, 2, 60, (9, 11), (36, 44)),     # flagship widths, x4
    (128, 1, 18, (7, 5), (20, 13)),      # ragged, non-integer scale
    (256, 2, 540, (9, 11), (12, 15)),    # the d = 27 patch model: 5 passes
    (128, 1, 129, (7, 5), (20, 13)),     # one column past a pass
    # the tiling's edges: one query less / more than a block, a grid
    # smaller than one block, no hidden layer, out_dim 1 / 128 / 129 / 1024
    (256, 2, 60, (9, 11), (1, K2_BLOCK - 1)),
    (256, 2, 60, (9, 11), (1, K2_BLOCK + 1)),
    (128, 1, 60, (7, 5), (5, 7)),
    (256, 0, 60, (9, 11), (20, 13)),
    (128, 0, 129, (7, 5), (20, 13)),
    (256, 1, 1, (9, 11), (20, 13)),
    (128, 2, 1, (7, 5), (3, 5)),
    (256, 2, 128, (9, 11), (16, 16)),
    (256, 1, 129, (9, 11), (17, 15)),
    (128, 1, 1024, (7, 5), (12, 11)),
    (256, 2, 1024, (9, 11), (16, 9)),
])
def test_k2_matches_twin_and_float64(dev, C, n_hidden, out_dim, hw, HW):
    (coef, freq, ys, xs, phase), args, mlp, mlp_t = _k2_case(
        C, n_hidden, out_dim, hw, HW, dev)
    got = linf_info.affine_info(*args, mlp_t)
    twin = linf_info.affine_info_plain(*args, mlp_t)
    cpu32 = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
             for a in (coef, freq, ys, xs, phase)]
    ref64 = linf_info.affine_info_plain(
        *(a.double() for a in cpu32),
        [(torch.from_numpy(wl), torch.from_numpy(bl)) for wl, bl in mlp])
    assert got.shape == (out_dim, HW[0] * HW[1])
    torch.testing.assert_close(got, twin, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got.cpu().numpy(), ref64.numpy(), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("C,n_hidden,out_dim,hw,HW", [
    (256, 2, 60, (9, 11), (36, 44)), (256, 2, 540, (9, 11), (12, 15)),
    (128, 1, 129, (7, 5), (20, 13))])
def test_k2_launches_are_bitwise_repeatable(dev, C, n_hidden, out_dim, hw,
                                            HW):
    """Two launches on the same inputs give the same bits: every sum is
    taken in one fixed order, with no atomics."""
    _, args, _, mlp_t = _k2_case(C, n_hidden, out_dim, hw, HW, dev)
    packed = linf_info.pack_mlp(mlp_t)
    first = linf_info.affine_info(*args, mlp_t, packed)
    second = linf_info.affine_info(*args, mlp_t, packed)
    assert torch.equal(first, second)


@pytest.mark.parametrize("cins,cout,act,hw", [
    ([3], 64, "relu", (37, 45)),
    ([3, 8, 8, 8, 8], 8, "lrelu", (19, 70)),
    ([16, 16], 16, None, (5, 3)),
    ([64, 64], 64, "lrelu", (64, 33)),
    ([35], 32, "lrelu", (40, 31)),
])
def test_k3_matches_twin_and_float64(dev, cins, cout, act, hw):
    g = _gen(sum(cins) + cout)
    xs = [g.standard_normal((1, *hw, c)) for c in cins]
    w = 0.2 * g.standard_normal((cout, sum(cins), 3, 3))
    scale = g.random(cout) + 0.5
    bias = g.standard_normal(cout)
    xt = [_t(x, dev) for x in xs]
    got = conv3x3.conv3x3_cat(xt, _t(w, dev), _t(scale, dev), _t(bias, dev),
                              act)
    twin = conv3x3.conv3x3_cat_plain(xt, _t(w, dev), _t(scale, dev),
                                     _t(bias, dev), act)
    ref64 = conv3x3.conv3x3_cat_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(w),
        torch.from_numpy(scale), torch.from_numpy(bias), act)
    torch.testing.assert_close(got, twin, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cpu().numpy(), ref64.numpy(), atol=1e-4)


def test_wrappers_raise_on_what_kernels_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_cat([x], torch.zeros((48, 8, 3, 3), device=dev))
    # the f32 K3 takes a batch, up to the grid's z extent
    assert conv3x3.conv3x3_cat(
        [torch.zeros((2, 4, 4, 8), device=dev)],
        torch.zeros((8, 8, 3, 3), device=dev)).shape == (2, 4, 4, 8)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_cat([torch.zeros((65536, 1, 1, 8), device=dev)],
                            torch.zeros((8, 8, 3, 3), device=dev))
    with pytest.raises(TypeError):
        conv3x3.conv3x3_cat([x.double()],
                            torch.zeros((8, 8, 3, 3), device=dev,
                                        dtype=torch.float64))
    f = torch.zeros((1, 2, 2, 32), device=dev)
    mlp = [(torch.zeros((32, 128), device=dev), torch.zeros(32, device=dev)),
           (torch.zeros((6, 32), device=dev), torch.zeros(6, device=dev))]
    with pytest.raises(ValueError):   # K2 takes hidden 128 or 256
        linf_info.affine_info(f, f, torch.zeros(4, device=dev),
                              torch.zeros(4, device=dev),
                              torch.zeros(16, device=dev), mlp)
    f = torch.zeros((1, 2, 2, 128), device=dev)
    mlp = [(torch.zeros((128, 512), device=dev), torch.zeros(128, device=dev)),
           (torch.zeros((1025, 128), device=dev), torch.zeros(1025, device=dev))]
    with pytest.raises(ValueError):   # and out_dim <= 1024
        linf_info.affine_info(f, f, torch.zeros(4, device=dev),
                              torch.zeros(4, device=dev),
                              torch.zeros(64, device=dev), mlp)
    w = torch.eye(5, device=dev).expand(2, 5, 5).contiguous()
    with pytest.raises(ValueError):   # K1 takes d = 3, K4 d = 12 / 27 / 48
        linf_flow.flow_forward(w, torch.zeros((2, 5), device=dev),
                               torch.zeros((7, 5), device=dev),
                               torch.zeros((10, 7), device=dev))


def test_small_predictor_kernel_path_matches_twins(dev):
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import example_inputs, flagship_specs
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    linf_spec, unet_spec = flagship_specs(tiny=True)
    linf_spec["args"]["hidden_dim"] = 128   # K2 takes hidden 128 / 256
    model = registry.make(linf_spec)
    model.reset_parameters(seeded(3))
    with torch.no_grad():
        for lin in [*model.imnet.linears, model.imnet.last]:
            lin._weight.add_(torch.eye(3))
    model = model.to(dev).freeze()
    unfrozen = registry.make(unet_spec).to(dev).eval()
    prior = registry.make(unet_spec).to(dev).eval().freeze()
    inputs = example_inputs(dev, (13, 10), (41, 29), seed=1)
    kcuda.reset_launch_counts()
    out = LINFPredictor(model, prior).predict(*inputs)
    linf_kernels = ("linf_flow_forward", "linf_flow_inverse", "linf_info",
                    "conv3x3_cat")
    assert all(kcuda.LAUNCHES[k] > 0 for k in linf_kernels), kcuda.LAUNCHES
    ref = LINFPredictor(model, prior, kernels=False).predict(*inputs)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-3)
    # an unfrozen prior lays its K3 weights out per call: the same image
    torch.testing.assert_close(LINFPredictor(model, unfrozen).predict(*inputs),
                               out, rtol=0, atol=0)
    # query_rgb / query_log_p run K2 (and query_rgb K1) on a CUDA tensor
    inp, coord, cell, gt = inputs
    feat = model.gen_feat(inp)
    kcuda.reset_launch_counts()
    rgb = model.query_rgb(inp, feat, coord, cell)
    log_p, _ = model.query_log_p(inp, feat, coord, cell, gt)
    assert kcuda.LAUNCHES["linf_info"] == 2, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["linf_flow_inverse"] == 1, kcuda.LAUNCHES
    torch.testing.assert_close(rgb, model.query_rgb(inp, feat, coord, cell,
                                                    kernels=False),
                               rtol=0, atol=1e-3)
    assert torch.isfinite(log_p).all()


def random_flow_step(c, hid=64, c_cond=320, seed=0):
    """A frozen conditional FlowStep with live random weights (nonzero
    actnorms and Conv2dZeros tails), and a matching random record."""
    from bfsr_tpu_torch.models.srflow.flow_upsampler import FlowStep

    g = _gen(seed)
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


def random_record(hw, c, hid=64, seed=1):
    g = _gen(seed)
    return np.concatenate([g.uniform(0.6, 1.0, (1, *hw, c)),
                           0.5 * g.standard_normal((1, *hw, c)),
                           g.standard_normal((1, *hw, hid))], -1)


# the f32 K5's output tiles (csrc/flow_step.cu): TY x TX of a block
# (Tile<C>) or, at C = 48 and 192, of a thread-block cluster (Wide<C>)
K5_TILES = {12: (8, 16), 24: (16, 8), 96: (4, 8), 48: (8, 8), 192: (11, 7)}
# at the wide levels, shapes of more tiles than the card holds clusters
# (66 of 2 CTAs, 15 of 8), so that a cluster takes a second tile
K5_MANY_TILES = {48: (100, 90), 192: (40, 47)}


def _k5_tile_shapes():
    """At each C: two tiles each way exactly, one pixel more in H and W,
    and (but C = 96) a 1-pixel row and a 1-pixel column; at C = 48 and
    192, a ragged shape of more tiles than resident clusters."""
    out = []
    for c, (ty, tx) in K5_TILES.items():
        out += [(c, (2 * ty, 2 * tx)), (c, (2 * ty + 1, 2 * tx + 1))]
        if c != 96:
            out += [(c, (1, 2 * tx + 1)), (c, (2 * ty + 1, 1))]
    return out + list(K5_MANY_TILES.items())


@pytest.mark.parametrize("c,hw", [(12, (37, 29)), (24, (20, 13)),
                                  (96, (15, 9)), (96, (1, 3)),
                                  (12, (64, 64))] + _k5_tile_shapes())
def test_k5_matches_twin_and_float64(dev, c, hw):
    step = random_flow_step(c, seed=c)
    packed = step.kpacked
    x = _gen(c + 7).standard_normal((1, *hw, c))
    rec = random_record(hw, c)
    xt, rt, pt = _t(x, dev), _t(rec, dev), packed.to(dev)
    before = dict(kcuda.LAUNCHES)
    y = flow_step.flow_step_forward(xt, rt, pt, 64)
    back = flow_step.flow_step_reverse(y, rt, pt, 64)
    assert kcuda.LAUNCHES["flow_step_forward"] == before["flow_step_forward"] + 1
    assert kcuda.LAUNCHES["flow_step_reverse"] == before["flow_step_reverse"] + 1
    torch.testing.assert_close(
        y, flow_step.flow_step_forward_plain(xt, rt, pt, 64),
        atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(
        back, flow_step.flow_step_reverse_plain(y, rt, pt, 64),
        atol=2e-4, rtol=2e-4)
    y64 = flow_step.flow_step_forward_plain(
        torch.from_numpy(x), torch.from_numpy(rec), packed.double(), 64)
    np.testing.assert_allclose(y.cpu().numpy(), y64.numpy(), atol=2e-4,
                               rtol=2e-4)
    r64 = flow_step.flow_step_reverse_plain(
        y.cpu().double(), torch.from_numpy(rec), packed.double(), 64)
    np.testing.assert_allclose(back.cpu().numpy(), r64.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(back.cpu().numpy(), x, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("c,hw", [(12, (37, 29)), (24, (20, 13)),
                                  (96, (15, 9)), (48, (20, 13)),
                                  (192, (9, 7))])
def test_k5_launches_are_bitwise_repeatable(dev, c, hw):
    """Two launches on the same inputs give the same bits: the split-K
    partial sums of conv3 meet in a fixed order, with no atomics."""
    step = random_flow_step(c, seed=c)
    x = _t(_gen(c + 7).standard_normal((1, *hw, c)), dev)
    rt, pt = _t(random_record(hw, c), dev), step.kpacked.to(dev)
    for fn in (flow_step.flow_step_forward, flow_step.flow_step_reverse):
        first = fn(x, rt, pt, 64)
        second = fn(x, rt, pt, 64)
        assert torch.equal(first, second)


def test_k5_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    step = random_flow_step(12, hid=16)
    x = torch.zeros((1, 4, 4, 12), device=dev)
    rec = torch.zeros((1, 4, 4, 2 * 12 + 16), device=dev)
    with pytest.raises(ValueError):   # K5 takes hidden 64 only
        flow_step.flow_step_forward(x, rec, step.kpacked.to(dev), 16)
    step = random_flow_step(36)
    x = torch.zeros((1, 4, 4, 36), device=dev)
    rec = torch.zeros((1, 4, 4, 2 * 36 + 64), device=dev)
    with pytest.raises(ValueError):   # and C in 12 / 24 / 48 / 96 / 192
        flow_step.flow_step_reverse(x, rec, step.kpacked.to(dev), 64)


@pytest.mark.parametrize("c,hw", [(12, (37, 29)), (24, (20, 13)),
                                  (96, (15, 9)), (96, (1, 3)), (12, (2, 1)),
                                  (24, (64, 33)), (96, (17, 2)),
                                  (48, (20, 13)), (192, (10, 10)),
                                  (192, (1, 3))])
def test_k5_bf16_matches_twin(dev, restore_mode, c, hw):
    """K5's one-pass kernel against its twin on the card, forward then
    reverse back to x.  Both round the same five operands; their f32 sums
    differ in order, which can flip the bf16 rounding of an intermediate
    at a tie by one bf16 unit and move the outputs near it by up to ~1e-2
    (PERF.md): so the max error is held at 2e-2 and the mean at 1e-4.
    The round trip is off x by the form's rounding."""
    step = random_flow_step(c, seed=c)
    x = _gen(c + 7).standard_normal((1, *hw, c))
    rec = random_record(hw, c)
    xt, rt = _t(x, dev), _t(rec, dev)
    pt, pb = step.kpacked.to(dev), step.kpacked_bf16.to(dev)
    restore_mode.set_default_precision("default")
    kcuda.reset_launch_counts()
    y = flow_step.flow_step_forward(xt, rt, pt, 64, pb)
    back = flow_step.flow_step_reverse(y, rt, pt, 64, pb)
    assert kcuda.LAUNCHES["flow_step_bf16_forward"] == 1, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["flow_step_bf16_reverse"] == 1, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["flow_step_forward"] == 0, kcuda.LAUNCHES
    for got, twin in (
            (y, flow_step.flow_step_forward_bf16_plain(xt, rt, pb, 64)),
            (back, flow_step.flow_step_reverse_bf16_plain(y, rt, pb, 64))):
        err = (got - twin).abs()
        assert torch.isfinite(got).all()
        assert float(err.max()) <= 2e-2, float(err.max())
        assert float(err.mean()) <= 1e-4, float(err.mean())
    np.testing.assert_allclose(back.cpu().numpy(), x, atol=5e-2)
    f32 = flow_step.flow_step_forward_plain(xt, rt, pt, 64)
    assert float((y - f32).abs().max()) > 1e-3   # the form rounded


def test_k5_bf16_wrapper_raises_on_what_the_kernel_does_not_take(
        dev, restore_mode):
    restore_mode.set_default_precision("default")
    step = random_flow_step(12)
    x = torch.zeros((1, 4, 4, 12), device=dev)
    rec = torch.zeros((1, 4, 4, 2 * 12 + 64), device=dev)
    pt, pb = step.kpacked.to(dev), step.kpacked_bf16.to(dev)
    with pytest.raises(ValueError, match="kpacked_bf16"):   # none given
        flow_step.flow_step_forward(x, rec, pt, 64)
    with pytest.raises(ValueError):   # the f32 buffer where bf16 is due
        flow_step.flow_step_forward(x, rec, pt, 64, pt)
    with pytest.raises(ValueError):   # on another device
        flow_step.flow_step_reverse(x, rec, pt, 64, step.kpacked_bf16)
    for form, other in (("xla", "pallas"), ("pallas", "xla")):
        po = flow_step.pack_step_bf16(step.actnorm, step.invconv,
                                      step.affine, other).to(dev)
        kcuda.reset_launch_counts()
        with pytest.raises(ValueError):   # the other form's buffer
            flow_step.flow_step_forward(x, rec, pt, 64, po, form)
        assert not any(kcuda.LAUNCHES.values()), kcuda.LAUNCHES
    with pytest.raises(ValueError):   # no such form
        flow_step.flow_step_forward(x, rec, pt, 64, pb, "tpu")
    step = random_flow_step(12, hid=16)
    rec = torch.zeros((1, 4, 4, 2 * 12 + 16), device=dev)
    with pytest.raises(ValueError):   # hidden 64 only
        flow_step.flow_step_forward(x, rec, step.kpacked.to(dev), 16,
                                    step.kpacked_bf16.to(dev))
    step = random_flow_step(36)
    x = torch.zeros((1, 4, 4, 36), device=dev)
    rec = torch.zeros((1, 4, 4, 2 * 36 + 64), device=dev)
    with pytest.raises(ValueError):   # and C in 12 / 24 / 48 / 96 / 192
        flow_step.flow_step_reverse(x, rec, step.kpacked.to(dev), 64,
                                    step.kpacked_bf16.to(dev))


@pytest.mark.parametrize("cins,cout", [([64, 32, 32, 32, 32], 64),
                                       ([64, 32], 32), ([64], 32)])
def test_k3_at_rrdb_dense_block_shapes(dev, cins, cout):
    g = _gen(sum(cins))
    hw = (40, 37)
    xs = [g.standard_normal((1, *hw, c)) for c in cins]
    w = g.standard_normal((cout, sum(cins), 3, 3)) / np.sqrt(9 * sum(cins))
    bias = g.standard_normal(cout)
    act = "lrelu" if cout == 32 else None
    xt = [_t(x, dev) for x in xs]
    got = conv3x3.conv3x3_cat(xt, _t(w, dev), None, _t(bias, dev), act)
    twin = conv3x3.conv3x3_cat_plain(xt, _t(w, dev), None, _t(bias, dev), act)
    ref64 = conv3x3.conv3x3_cat_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(w), None,
        torch.from_numpy(bias), act)
    torch.testing.assert_close(got, twin, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cpu().numpy(), ref64.numpy(), atol=1e-4)


def test_small_srflow_lp_kernel_path_matches_twins(dev):
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor

    # the smallest config the kernels take: K3 Cout 16 (gc) / 16 (nf),
    # K5 hidden 64
    model = registry.make({"name": "srflow", "args": {
        "nf": 16, "nb": 2, "gc": 16, "K": 2, "L": 3, "hidden_channels": 64,
        "stack_blocks": (0, 1)}})
    model.reset_parameters(seeded(3))
    prior = registry.make({"name": "srflow-unet",
                           "args": {"depth": 2, "dim": 16}})
    prior.reset_parameters(seeded(4))
    model = model.to(dev).eval().freeze()
    prior = prior.to(dev).eval().freeze()
    lr = _t(_gen(5).random((13, 10, 3)), dev)
    kcuda.reset_launch_counts()
    out = SRFlowLPPredictor(model, prior).predict(lr)
    launches = dict(kcuda.LAUNCHES)
    ref = SRFlowLPPredictor(model, prior, kernels=False).predict(lr)
    assert out.shape == (52, 40, 3) and torch.isfinite(out).all()
    assert launches["flow_step_forward"] == 6, launches
    assert launches["flow_step_reverse"] == 6, launches
    assert launches["conv3x3_cat"] == 2 * 3 * 5 + 2 * (5 + 2 + 2), launches
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-3)
    # unclipped, where most of a random flow's image lies outside [0, 1]
    x = lr[None, :12].contiguous()
    sr = SRFlowLPPredictor(model, prior).run(x)
    sr_ref = SRFlowLPPredictor(model, prior, kernels=False).run(x)
    torch.testing.assert_close(sr, sr_ref, rtol=0,
                               atol=1e-3 * float(sr_ref.abs().max()))


def test_small_patch_predictor_kernel_path_matches_twins(dev):
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import example_patch_inputs, patch_specs
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    linf_spec, unet_spec = patch_specs(tiny=True)
    linf_spec["args"]["hidden_dim"] = 128   # K2 takes hidden 128 / 256
    model = registry.make(linf_spec)
    model.reset_parameters(seeded(3))
    with torch.no_grad():
        for lin in [*model.imnet.linears, model.imnet.last]:
            lin._weight.mul_(0.05).add_(torch.eye(27))
    model = model.to(dev).freeze()
    prior = registry.make(unet_spec).to(dev).eval().freeze()
    inputs = example_patch_inputs(dev, (13, 10), (17, 14), seed=1)
    kcuda.reset_launch_counts()
    out = LINFPredictor(model, prior).predict(*inputs)
    launches = dict(kcuda.LAUNCHES)
    ref = LINFPredictor(model, prior, kernels=False).predict(*inputs)
    assert out.shape == (1, 51, 42, 3) and torch.isfinite(out).all()
    assert launches["linf_flow_nd_forward"] == 1, launches
    assert launches["linf_flow_nd_inverse"] == 1, launches
    assert launches["linf_info"] == 1, launches
    assert launches["linf_flow_forward"] == 0, launches
    assert launches["conv3x3_cat"] == 2 * 2 + 2 + 5 + 2 + 2, launches
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-4)


# --- the bf16 serving modes: K3's one-pass form, K6, the counters per mode


@pytest.fixture
def restore_mode():
    from bfsr_tpu_torch.ops import nn as fnn

    saved = fnn.precision_mode()
    yield fnn
    fnn.set_default_precision(saved)


@pytest.mark.parametrize("cins,cout,act,hw", [
    ([3], 64, "relu", (37, 45)),
    ([3, 32, 32, 32, 32], 32, "lrelu", (19, 70)),
    ([16, 16], 16, None, (5, 3)),
    ([64, 64], 64, "lrelu", (64, 33)),
    ([35, 6, 64], 8, "lrelu", (40, 31)),
    ([64], 192, None, (33, 34)),
    ([6, 64, 64, 64], 64, None, (1, 17)),
])
def test_k3_bf16_matches_twin_and_float64(dev, cins, cout, act, hw):
    """Both sides multiply the same bf16 values exactly: they differ only
    in the order of the f32 sums (1e-4 abs + 1e-4 rel)."""
    g = _gen(sum(cins) + cout + 1)
    xs = [g.standard_normal((1, *hw, c)) for c in cins]
    w = 0.2 * g.standard_normal((cout, sum(cins), 3, 3))
    scale = g.random(cout) + 0.5
    bias = g.standard_normal(cout)
    xt = [_t(x, dev) for x in xs]
    args = (_t(w, dev), _t(scale, dev), _t(bias, dev), act)
    before = kcuda.LAUNCHES["conv3x3_cat_bf16"]
    got = conv3x3.conv3x3_cat_bf16(xt, *args)
    assert kcuda.LAUNCHES["conv3x3_cat_bf16"] == before + 1
    twin = conv3x3.conv3x3_cat_bf16_plain(xt, *args)
    torch.testing.assert_close(got, twin, rtol=1e-4, atol=1e-4)
    r = lambda a: torch.from_numpy(a).float().to(torch.bfloat16).double()
    ref64 = conv3x3.conv3x3_cat_plain(
        [r(x) for x in xs], r(w), torch.from_numpy(scale),
        torch.from_numpy(bias), act)
    np.testing.assert_allclose(got.cpu().numpy(), ref64.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_k3_follows_the_stage_precision(dev, restore_mode):
    fnn = restore_mode
    g = _gen(9)
    xs = [_t(g.standard_normal((1, 20, 18, c)), dev) for c in (32, 32)]
    w = _t(0.2 * g.standard_normal((64, 64, 3, 3)), dev)
    counts = {}
    for mode, stage in (("high", None), ("mixed", "encoder"),
                        ("mixed", "prior"), ("default", None)):
        fnn.set_default_precision(mode)
        kcuda.reset_launch_counts()
        with fnn.stage(stage):
            got = conv3x3.conv3x3_cat(xs, w, act="lrelu")
            twin = conv3x3.conv3x3_cat_twin(xs, w, act="lrelu")
        counts[mode, stage] = (kcuda.LAUNCHES["conv3x3_cat"],
                               kcuda.LAUNCHES["conv3x3_cat_bf16"])
        torch.testing.assert_close(got, twin, rtol=1e-4, atol=1e-4)
    assert counts == {("high", None): (1, 0), ("mixed", "encoder"): (1, 0),
                      ("mixed", "prior"): (0, 1), ("default", None): (0, 1)}


@pytest.mark.parametrize("cout,hw,launches", [(4, (10, 6), 1), (16, (16, 12), 1),
                                              (100, (21, 19), 2)])
def test_k6_matches_twin(dev, restore_mode, cout, hw, launches):
    """K6 on K3's f32 kernel: Cout padded to K3's widths in 64-wide
    launches and cropped; f32 under ``default`` too."""
    g = _gen(cout)
    x = _t(g.standard_normal((1, *hw, 8)), dev)
    w = _t(g.random((cout, 8, 3, 3)) - 0.5, dev)
    s = _t(g.random(cout) + 0.5, dev)
    b = _t(g.standard_normal(cout), dev)
    restore_mode.set_default_precision("default")
    kcuda.reset_launch_counts()
    got = conv3x3.conv3x3_fused(x, w, s, b, "lrelu")
    assert kcuda.LAUNCHES["conv3x3_fused"] == launches, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["conv3x3_cat"] == 0
    assert kcuda.LAUNCHES["conv3x3_cat_bf16"] == 0
    assert got.shape == (1, *hw, cout) and got.is_contiguous()
    torch.testing.assert_close(
        got, conv3x3.conv3x3_cat_plain([x], w, s, b, "lrelu"), rtol=0,
        atol=1e-4)


def test_bf16_wrappers_raise_on_what_kernels_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    with pytest.raises(ValueError):   # Cout 48: neither <= 64 in 16s nor 64s
        conv3x3.conv3x3_cat_bf16([x], torch.zeros((48, 8, 3, 3), device=dev))
    with pytest.raises(ValueError):   # past the grid: B x 2 Cout blocks
        conv3x3.conv3x3_cat_bf16(
            [torch.zeros((40000, 1, 1, 8), device=dev)],
            torch.zeros((128, 8, 3, 3), device=dev))
    w = torch.zeros((16, 8, 3, 3), device=dev)
    with pytest.raises(ValueError):   # an f32 layout where bf16 is due
        conv3x3.conv3x3_cat_bf16([x], w,
                                 kweight_bf16=conv3x3.kernel_weight(w))
    with pytest.raises(ValueError):   # K6: batch 1 only
        conv3x3.conv3x3_fused(torch.zeros((2, 4, 4, 8), device=dev), w)


def test_small_predictors_count_launches_per_mode(dev, restore_mode):
    """The small LINF-LP predictor in each mode: the bf16 K3 takes the
    prior's 9 full-resolution convs under ``mixed`` and all 15 under
    ``default``; K1 and K2 stay f32; the image agrees with the twin path
    in the same mode.  SRFlow-LP under ``mixed``: the bf16 K3 only in
    the prior (2 branches x 9), K5 6 + 6; under ``default``: the bf16 K3
    on the RRDB's 30 dense-block convs and the prior's 18, K5's one-pass
    form 6 + 6, no f32 kernel; the image within bf16 rounding of the twin
    path (whose unfused steps keep the fold in f32)."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import example_inputs, flagship_specs
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor
    from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor

    fnn = restore_mode
    linf_spec, unet_spec = flagship_specs(tiny=True)
    linf_spec["args"]["hidden_dim"] = 128   # K2 takes hidden 128 / 256
    model = registry.make(linf_spec)
    model.reset_parameters(seeded(3))
    with torch.no_grad():
        for lin in [*model.imnet.linears, model.imnet.last]:
            lin._weight.add_(torch.eye(3))
    model = model.to(dev).freeze()
    prior = registry.make(unet_spec).to(dev).eval().freeze()
    inputs = example_inputs(dev, (13, 10), (41, 29), seed=1)
    want = {"high": (15, 0), "mixed": (6, 9), "default": (0, 15)}
    outs = {}
    for mode, (f32, bf16) in want.items():
        fnn.set_default_precision(mode)
        kcuda.reset_launch_counts()
        outs[mode] = LINFPredictor(model, prior).predict(*inputs)
        got = dict(kcuda.LAUNCHES)
        assert (got["conv3x3_cat"], got["conv3x3_cat_bf16"]) == (f32, bf16), got
        assert got["linf_info"] == got["linf_flow_forward"] == 1, got
        assert got["linf_flow_inverse"] == 1, got
        ref = LINFPredictor(model, prior, kernels=False).predict(*inputs)
        assert torch.isfinite(outs[mode]).all()
        torch.testing.assert_close(outs[mode], ref, rtol=0, atol=1e-3)
    assert not torch.equal(outs["default"], outs["high"])

    smodel = registry.make({"name": "srflow", "args": {
        "nf": 16, "nb": 2, "gc": 16, "K": 2, "L": 3, "hidden_channels": 64,
        "stack_blocks": (0, 1)}})
    smodel.reset_parameters(seeded(3))
    sprior = registry.make({"name": "srflow-unet",
                            "args": {"depth": 2, "dim": 16}})
    sprior.reset_parameters(seeded(4))
    smodel = smodel.to(dev).eval().freeze()
    sprior = sprior.to(dev).eval().freeze()
    lr = _t(_gen(5).random((13, 10, 3)), dev)
    fnn.set_default_precision("mixed")
    kcuda.reset_launch_counts()
    out = SRFlowLPPredictor(smodel, sprior).predict(lr)
    got = dict(kcuda.LAUNCHES)
    assert got["conv3x3_cat_bf16"] == 18 and got["conv3x3_cat"] == 30, got
    assert got["flow_step_forward"] == got["flow_step_reverse"] == 6, got
    ref = SRFlowLPPredictor(smodel, sprior, kernels=False).predict(lr)
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-3)
    fnn.set_default_precision("default")
    kcuda.reset_launch_counts()
    out = SRFlowLPPredictor(smodel, sprior).predict(lr)
    got = dict(kcuda.LAUNCHES)
    assert got["conv3x3_cat_bf16"] == 48 and got["conv3x3_cat"] == 0, got
    assert got["flow_step_bf16_forward"] == 6, got
    assert got["flow_step_bf16_reverse"] == 6, got
    assert got["flow_step_forward"] == got["flow_step_reverse"] == 0, got
    ref = SRFlowLPPredictor(smodel, sprior, kernels=False).predict(lr)
    assert out.shape == (52, 40, 3) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-2)


def _k3_case(cins, cout, hw, seed):
    g = _gen(seed)
    xs = [g.standard_normal((1, *hw, c)) for c in cins]
    w = g.standard_normal((cout, sum(cins), 3, 3)) / np.sqrt(9 * sum(cins))
    return xs, w, g.random(cout) + 0.5, g.standard_normal(cout)


# extents off every tile (7 x 130, 129 x 33), the RRDB's 128^2 and one
# large enough for the 8-row tiles (256 x 544: at least 4 blocks per SM)
K3_TILINGS = [
    ([3], (7, 130)), ([3, 5, 7, 9, 11], (129, 33)),
    ([64, 32, 32, 32], (128, 128)), ([131], (256, 544)), ([6, 64], (129, 33)),
    ([64, 64], (256, 544)),
]


@pytest.mark.parametrize("cins,hw", K3_TILINGS)
@pytest.mark.parametrize("cout", [8, 16, 32, 64])
def test_k3_tilings_match_twin(dev, cins, hw, cout):
    """K3's f32 kernel at every Cout on each tile choice, ragged edges,
    1-5 inputs, odd per-input channel counts: against its twin at 1e-4
    (f32 products, sums in another order)."""
    xs, w, s, b = _k3_case(cins, cout, hw, sum(cins) + cout)
    xt, args = [_t(x, dev) for x in xs], (_t(w, dev), _t(s, dev), _t(b, dev))
    before = kcuda.LAUNCHES["conv3x3_cat"]
    got = conv3x3.conv3x3_cat(xt, *args, "lrelu")
    assert kcuda.LAUNCHES["conv3x3_cat"] == before + 1
    torch.testing.assert_close(
        got, conv3x3.conv3x3_cat_plain(xt, *args, "lrelu"), rtol=0, atol=1e-4)


@pytest.mark.parametrize("cins,hw", K3_TILINGS)
@pytest.mark.parametrize("cout", [8, 16, 32, 64, 128, 192])
def test_k3_bf16_tilings_match_twin(dev, cins, hw, cout):
    """The bf16 K3 at every Cout it takes (above 64 in 64-wide blocks) on
    each tile choice: against its twin at 1e-4 abs + 1e-4 rel (the same
    bf16 products, f32 sums in another order)."""
    xs, w, s, b = _k3_case(cins, cout, hw, sum(cins) + cout + 1)
    xt, args = [_t(x, dev) for x in xs], (_t(w, dev), _t(s, dev), _t(b, dev))
    before = kcuda.LAUNCHES["conv3x3_cat_bf16"]
    got = conv3x3.conv3x3_cat_bf16(xt, *args, "relu")
    assert kcuda.LAUNCHES["conv3x3_cat_bf16"] == before + 1
    torch.testing.assert_close(
        got, conv3x3.conv3x3_cat_bf16_plain(xt, *args, "relu"), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("cout,hw", [(64, (256, 544)), (100, (129, 33))])
def test_k6_on_both_f32_tiles(dev, cout, hw):
    """K6 through K3's f32 kernel on its 8-row tile and its small one."""
    xs, w, s, b = _k3_case([64], cout, hw, cout)
    x = _t(xs[0], dev)
    args = (_t(w, dev), _t(s, dev), _t(b, dev), "lrelu")
    got = conv3x3.conv3x3_fused(x, *args)
    torch.testing.assert_close(
        got, conv3x3.conv3x3_cat_plain([x], *args), rtol=0, atol=1e-4)


def _frame(t):
    """The 1-pixel frame of a (1, H, W, C) map, flattened: where the masks
    of z1 and of the hidden map decide the result."""
    m = torch.zeros(t.shape[1:3], dtype=torch.bool, device=t.device)
    m[0], m[-1], m[:, 0], m[:, -1] = True, True, True, True
    return t[0][m]


# the one-pass K5's output tiles at the wide levels (csrc/flow_step_bf16.cu,
# BWide<C>): TY x TX of a thread-block cluster (2 CTAs at C = 48, 8 at C =
# 192); the 8x samples' level shapes there (LR 64^2 and 50 x 42)
K5_BF16_TILES = {48: (8, 8), 192: (11, 7)}
K5_BF16_SAMPLE_SHAPES = {48: [(64, 64), (50, 42)], 192: [(32, 32), (25, 21)]}


def _k5_bf16_tile_shapes():
    """At C = 48 and 192: two tiles each way exactly, one pixel more each
    way, a 1-pixel row and a 1-pixel column, a shape of more tiles than
    the card holds clusters (``K5_MANY_TILES``: 156 tiles at C = 48, 28 at
    C = 192), and the 8x samples' level shapes."""
    out = []
    for c, (ty, tx) in K5_BF16_TILES.items():
        out += [(c, (2 * ty, 2 * tx)), (c, (2 * ty + 1, 2 * tx + 1)),
                (c, (1, 2 * tx + 1)), (c, (2 * ty + 1, 1)),
                (c, K5_MANY_TILES[c])]
        out += [(c, hw) for hw in K5_BF16_SAMPLE_SHAPES[c]]
    return out


# shapes that no tile of the one-pass K5 divides, at every level (C = 96
# streams W3 through its tap ring)
K5_BF16_RAGGED = [(c, hw) for c in (12, 24, 96, 48, 192)
                  for hw in ((1, 3), (2, 1), (17, 2), (37, 29), (64, 33))]


@pytest.mark.parametrize("form", ["xla", "pallas"])
@pytest.mark.parametrize("c,hw", [(24, (20, 13)), (96, (15, 9))]
                         + K5_BF16_RAGGED + _k5_bf16_tile_shapes())
def test_k5_bf16_forms_match_their_twins(dev, restore_mode, form, c, hw):
    """Each one-pass form against its own twin at each level, forward then
    reverse: the same operands rounded, sums in another order (max 2e-2 for
    a tie flip, mean 1e-4), over the whole image and over its 1-pixel
    frame alone, where a missed mask would show.  The two forms are two
    answers."""
    step = random_flow_step(c, seed=c)
    pb = flow_step.pack_step_bf16(step.actnorm, step.invconv, step.affine,
                                  form).to(dev)
    x = _gen(c + 9).standard_normal((1, *hw, c))
    xt, rt = _t(x, dev), _t(random_record(hw, c), dev)
    pt = step.kpacked.to(dev)
    restore_mode.set_default_precision("default")
    kcuda.reset_launch_counts()
    y = flow_step.flow_step_forward(xt, rt, pt, 64, pb, form)
    back = flow_step.flow_step_reverse(y, rt, pt, 64, pb, form)
    name = "flow_step_bf16" if form == "xla" else "flow_step_bf16_pallas"
    assert kcuda.LAUNCHES[f"{name}_forward"] == 1, kcuda.LAUNCHES
    assert kcuda.LAUNCHES[f"{name}_reverse"] == 1, kcuda.LAUNCHES
    fwd = flow_step.BF16_FORMS[form, False][1]
    rev = flow_step.BF16_FORMS[form, True][1]
    for got, twin in ((y, fwd(xt, rt, pb, 64)), (back, rev(y, rt, pb, 64))):
        assert torch.isfinite(got).all()
        for g, t in ((got, twin), (_frame(got), _frame(twin))):
            err = (g - t).abs()
            assert float(err.max()) <= 2e-2, float(err.max())
            assert float(err.mean()) <= 1e-4, float(err.mean())
    other = "pallas" if form == "xla" else "xla"
    po = flow_step.pack_step_bf16(step.actnorm, step.invconv, step.affine,
                                  other).to(dev)
    y2 = flow_step.flow_step_forward(xt, rt, pt, 64, po, other)
    assert float((y - y2).abs().max()) > 1e-4


@pytest.mark.parametrize("form", ["xla", "pallas"])
@pytest.mark.parametrize("c,hw", [(12, (37, 29)), (24, (20, 13)),
                                  (96, (15, 9)), (96, (64, 33)),
                                  (48, (20, 13)), (192, (10, 10))]
                         + _k5_bf16_tile_shapes())
def test_k5_bf16_launches_are_bitwise_repeatable(dev, restore_mode, form, c,
                                                 hw):
    """Two launches of a one-pass form on the same inputs give the same
    bits: every sum runs in a fixed order, with no atomics."""
    restore_mode.set_default_precision("default")
    step = random_flow_step(c, seed=c)
    pb = flow_step.pack_step_bf16(step.actnorm, step.invconv, step.affine,
                                  form).to(dev)
    x = _t(_gen(c + 7).standard_normal((1, *hw, c)), dev)
    rt = _t(random_record(hw, c), dev)
    for fn in (flow_step.flow_step_forward, flow_step.flow_step_reverse):
        first = fn(x, rt, None, 64, pb, form)
        second = fn(x, rt, None, 64, pb, form)
        assert torch.equal(first, second)


# --- the trainer's batch: K3 and K2 at B > 1, K1's inverse gradient ------


@pytest.mark.parametrize("cins,cout,act,hw,batch", [
    ([64], 64, "relu", (48, 48), 3),      # the encoder's conv at B 3
    ([3], 64, None, (37, 45), 3),         # the head conv, ragged
    ([8, 8, 8], 32, "lrelu", (19, 70), 2),
    ([64], 64, None, (96, 128), 5),       # enough blocks for the TH 8 tile
])
def test_batched_k3_matches_twin_and_batch_1(dev, cins, cout, act, hw,
                                             batch):
    g = _gen(sum(cins) + cout + batch)
    xs = [_t(g.standard_normal((batch, *hw, c)), dev) for c in cins]
    w = _t(0.2 * g.standard_normal((cout, sum(cins), 3, 3)), dev)
    b = _t(g.standard_normal(cout), dev)
    got = conv3x3.conv3x3_cat(xs, w, None, b, act)
    assert got.shape == (batch, *hw, cout)
    twin = conv3x3.conv3x3_cat_plain(xs, w, None, b, act)
    torch.testing.assert_close(got, twin, rtol=0, atol=1e-4)
    if batch * ((hw[1] + 31) // 32) * ((hw[0] + 7) // 8) < 4 * 132:
        # the same tile at B = 1: each image's bits are its own launch's
        for i in range(batch):
            one = conv3x3.conv3x3_cat([x[i:i + 1] for x in xs], w, None, b,
                                      act)
            assert torch.equal(got[i:i + 1], one), i


def _k2_batch(C, n_hidden, out_dim, hw, HWs, dev):
    """K2 inputs for a batch of samples, each with its own axes (a crop
    of the extent HWs[0] from a grid of HWs[b]) and phase."""
    g = _gen(C + len(HWs))
    B, (H, W) = len(HWs), HWs[0]
    coef = _t(g.standard_normal((B, *hw, C)), dev)
    freq = _t(g.standard_normal((B, *hw, C)), dev)
    ys, xs = [], []
    for n_y, n_x in HWs:
        y0, x0 = g.integers(0, n_y - H + 1), g.integers(0, n_x - W + 1)
        ys.append(((np.arange(n_y) * 2 + 1) / n_y - 1)[y0:y0 + H])
        xs.append(((np.arange(n_x) * 2 + 1) / n_x - 1)[x0:x0 + W])
    phase = _t(g.standard_normal((B, C // 2)), dev)
    dims = [4 * C] + [C] * (n_hidden + 1) + [out_dim]
    mlp = [(_t(g.uniform(-1, 1, (o, i)) / np.sqrt(i), dev),
            _t(0.1 * g.standard_normal(o), dev))
           for i, o in zip(dims[:-1], dims[1:])]
    return coef, freq, _t(np.stack(ys), dev), _t(np.stack(xs), dev), phase, mlp


@pytest.mark.parametrize("C,n_hidden,out_dim,hw,crops", [
    # B 3 crops of 48^2 from x1.5 / x2.7 / x4 grids of a 48^2 LR
    (256, 2, 60, (48, 48), [(72, 72), (130, 130), (192, 192)]),
    # ragged: a crop of 13 x 29 at three scales of a 7 x 11 LR
    (128, 1, 60, (7, 11), [(13, 29), (20, 40), (27, 31)]),
    (256, 2, 540, (9, 11), [(12, 15), (30, 20)]),
])
def test_batched_k2_matches_twin_and_batch_1(dev, C, n_hidden, out_dim, hw,
                                             crops):
    coef, freq, cy, cx, phase, mlp = _k2_batch(C, n_hidden, out_dim, hw,
                                               crops, dev)
    H, W = crops[0]
    got = linf_info.affine_info(coef, freq, cy, cx, phase, mlp)
    assert got.shape == (out_dim, len(crops) * H * W)
    twin = linf_info.affine_info_plain(coef, freq, cy, cx, phase, mlp)
    torch.testing.assert_close(got, twin, atol=2e-4, rtol=1e-4)
    for b in range(len(crops)):
        one = linf_info.affine_info(coef[b:b + 1], freq[b:b + 1], cy[b],
                                    cx[b], phase[b], mlp)
        assert torch.equal(got[:, b * H * W:(b + 1) * H * W], one), b


def test_flow_inverse_gradient_on_the_card(dev):
    g = _gen(3)
    n_layers, n = 10, 36864
    w = g.uniform(-1, 1, (n_layers + 1, 3, 3)) / np.sqrt(8) + np.eye(3)
    b = _t(0.1 * g.standard_normal((n_layers + 1, 3)), dev)
    w_inv = _t(np.linalg.inv(w), dev)
    info = _t(0.5 * g.standard_normal((6 * n_layers, n)), dev)
    z = _t(g.standard_normal((n, 3)), dev).requires_grad_(True)
    up = _t(g.standard_normal((n, 3)), dev)
    before = kcuda.LAUNCHES["linf_flow_inverse"]
    x = linf_flow.flow_inverse_diff(w_inv, b, z, info)
    assert kcuda.LAUNCHES["linf_flow_inverse"] == before + 1
    (gz,) = torch.autograd.grad(x, z, up)
    zr = z.detach().requires_grad_(True)
    xr = linf_flow.flow_inverse_plain(w_inv, b, zr, info)
    (gr,) = torch.autograd.grad(xr, zr, up)
    torch.testing.assert_close(x, xr, rtol=0, atol=1e-4)
    torch.testing.assert_close(gz, gr, rtol=0, atol=1e-5)


def test_small_train_step_kernel_path_matches_twin_path(dev):
    """One LINF-LP train step at the tiny size (hidden 128 for K2) on the
    kernel path and on the twin path from the same state: K3 on the
    encoder's 6 convs, K2 once, K1 twice forward (with the latent loss)
    and once inverse; the losses and the prior's gradients agree."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import example_train_batch, flagship_specs
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    linf_spec, unet_spec = flagship_specs(tiny=True)
    linf_spec["args"]["hidden_dim"] = 128
    model = registry.make(linf_spec)
    model.reset_parameters(seeded(3))
    with torch.no_grad():
        for lin in [*model.imnet.linears, model.imnet.last]:
            lin._weight.add_(torch.eye(3))
    model = model.to(dev).freeze()
    prior = registry.make(unet_spec).to(dev).train()
    vgg = registry.make({"name": "VGGFeatureExtractor", "args": {
        "feature_layer": 8}}).to(dev).requires_grad_(False)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    batch = example_train_batch(dev, 0, batch=3, inp_size=12)
    kcuda.reset_launch_counts()
    mets, grads, _ = make_train_step(model, prior, vgg, opt,
                                     latent_weight=1.0).loss_and_grads(batch)
    assert kcuda.LAUNCHES["conv3x3_cat"] == 6, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["linf_info"] == 1, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["linf_flow_forward"] == 2, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["linf_flow_inverse"] == 1, kcuda.LAUNCHES
    ref_mets, ref_grads, _ = make_train_step(
        model, prior, vgg, opt, latent_weight=1.0,
        kernels=False).loss_and_grads(batch)
    for k in mets:
        torch.testing.assert_close(mets[k], ref_mets[k], rtol=1e-4, atol=0)
    for name, g in grads.items():
        scale = float(ref_grads[name].abs().max())
        torch.testing.assert_close(g, ref_grads[name], rtol=0,
                                   atol=1e-3 * scale)


# --- the patch trainer and the bf16 modes: the bf16 K3 at B > 1, K2 at
# out 540 over 16 crops, K4 and FlowInverse at d = 27 ---------------------


@pytest.mark.parametrize("cins,cout,act,hw,batch", [
    ([64], 64, "relu", (48, 48), 16),     # the pixel trainer's encoder
    ([3], 64, None, (48, 48), 16),        # its head conv
    ([64], 64, "relu", (144, 144), 16),   # the patch trainer's encoder
    ([3], 64, None, (144, 144), 16),
    ([16, 8], 192, "lrelu", (13, 21), 3),  # three Cout blocks, ragged
    ([8], 32, None, (19, 70), 2),
])
def test_batched_k3_bf16_matches_twin_and_batch_1(dev, cins, cout, act, hw,
                                                  batch):
    g = _gen(sum(cins) + cout + batch)
    xs = [_t(g.standard_normal((batch, *hw, c)), dev) for c in cins]
    w = _t(0.2 * g.standard_normal((cout, sum(cins), 3, 3)), dev)
    b = _t(g.standard_normal(cout), dev)
    before = kcuda.LAUNCHES["conv3x3_cat_bf16"]
    got = conv3x3.conv3x3_cat_bf16(xs, w, None, b, act)
    assert kcuda.LAUNCHES["conv3x3_cat_bf16"] == before + 1
    assert got.shape == (batch, *hw, cout)
    twin = conv3x3.conv3x3_cat_bf16_plain(xs, w, None, b, act)
    torch.testing.assert_close(got, twin, rtol=1e-4, atol=1e-4)
    n_blocks = max(1, cout // 64)
    if batch * n_blocks * ((hw[1] + 31) // 32) * ((hw[0] + 7) // 8) \
            < 4 * 132:
        # the same tile at B = 1: each image's bits are its own launch's
        for i in range(batch):
            one = conv3x3.conv3x3_cat_bf16([x[i:i + 1] for x in xs], w, None,
                                           b, act)
            assert torch.equal(got[i:i + 1], one), i


def test_k2_at_out_540_over_16_crops(dev):
    """The patch trainer's info: 16 crops' 48^2 centre grids (each a window
    of its own scale's grid) over 144^2 LR features, out 540."""
    crops = [(48, 48)] + [(48 + 9 * i, 48 + 7 * i) for i in range(1, 16)]
    coef, freq, cy, cx, phase, mlp = _k2_batch(256, 2, 540, (144, 144),
                                               crops, dev)
    got = linf_info.affine_info(coef, freq, cy, cx, phase, mlp)
    assert got.shape == (540, 16 * 48 * 48)
    twin = linf_info.affine_info_plain(coef, freq, cy, cx, phase, mlp)
    torch.testing.assert_close(got, twin, atol=2e-4, rtol=1e-4)


def test_k4_and_flow_inverse_at_the_patch_trainers_n(dev):
    """K4 forward and inverse at d = 27, L = 10, N = 16 x 48^2 = 36,864,
    and FlowInverse's gradient against autograd through the twin."""
    w, b, x, info, w_inv = _k4_case(27, 10, 36864)
    wt, bt, xt, it = (_t(a, dev) for a in (w, b, x, info))
    wit = _t(w_inv, dev)
    z = linf_flow.flow_forward(wt, bt, xt, it)
    torch.testing.assert_close(
        z, linf_flow.flow_forward_plain(wt, bt, xt, it), rtol=0, atol=2e-5)
    zr = z.detach().requires_grad_(True)
    before = kcuda.LAUNCHES["linf_flow_nd_inverse"]
    xr = linf_flow.flow_inverse_diff(wit, bt, zr, it)
    assert kcuda.LAUNCHES["linf_flow_nd_inverse"] == before + 1
    torch.testing.assert_close(
        xr, linf_flow.flow_inverse_plain(wit, bt, z, it), rtol=0, atol=2e-4)
    up = _t(_gen(5).standard_normal((36864, 27)), dev)
    (gz,) = torch.autograd.grad(xr, zr, up)
    zt = z.detach().requires_grad_(True)
    (gt,) = torch.autograd.grad(linf_flow.flow_inverse_plain(wit, bt, zt, it),
                                zt, up)
    torch.testing.assert_close(gz, gt, rtol=0, atol=1e-5 * float(
        gt.abs().max()))


def test_small_patch_train_step_kernel_path_matches_twin_path(dev):
    """One patch train step (ps = 3) at the tiny size (hidden 128 for K2)
    on the kernel path and on the twin path from the same state: K3 on
    the encoder's 6 convs, K2 once, K4 twice forward (with the latent
    loss) and once inverse, no K1; the losses and gradients agree."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import (example_patch_train_batch,
                                      he_normal_vgg, patch_specs)
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    linf_spec, unet_spec = patch_specs(tiny=True)
    linf_spec["args"]["hidden_dim"] = 128
    model = registry.make(linf_spec)
    model.reset_parameters(seeded(3))
    with torch.no_grad():
        for lin in [*model.imnet.linears, model.imnet.last]:
            lin._weight.mul_(0.05).add_(torch.eye(27))
    model = model.to(dev).freeze()
    prior = registry.make(unet_spec).to(dev).train()
    vgg = he_normal_vgg(dev, tiny=True)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    batch = example_patch_train_batch(dev, 0, batch=3, inp_size=8)
    kcuda.reset_launch_counts()
    mets, grads, _ = make_train_step(model, prior, vgg, opt,
                                     latent_weight=1.0).loss_and_grads(batch)
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": 6, "linf_info": 1, "linf_flow_nd_forward": 2,
        "linf_flow_nd_inverse": 1}, kcuda.LAUNCHES
    ref_mets, ref_grads, _ = make_train_step(
        model, prior, vgg, opt, latent_weight=1.0,
        kernels=False).loss_and_grads(batch)
    for k in mets:
        torch.testing.assert_close(mets[k], ref_mets[k], rtol=1e-4, atol=0)
    for name, g in grads.items():
        scale = float(ref_grads[name].abs().max())
        torch.testing.assert_close(g, ref_grads[name], rtol=0,
                                   atol=1e-3 * scale)


# --- the SRFlow-LP prior trainer: K5 at a batch, FlowStepReverse ----------


def _k5_batch(c, hw, batch, dev, seed=0):
    """x (B, H, W, C) and records (B, H, W, 2C + 64), each image its own."""
    x = _gen(c + seed).standard_normal((batch, *hw, c))
    rec = np.concatenate([random_record(hw, c, seed=seed + i)
                          for i in range(batch)])
    return _t(x, dev), _t(rec, dev)


@pytest.mark.parametrize("form", [None, "xla", "pallas"])
@pytest.mark.parametrize("c,hw,batch", [(12, (37, 29), 3), (24, (20, 13), 4),
                                        (96, (15, 9), 5), (96, (1, 3), 2),
                                        (12, (80, 80), 12), (48, (20, 20), 12),
                                        (48, (13, 37), 5), (192, (10, 10), 12),
                                        (192, (11, 9), 7)]
                         + [(c, hw, 2) for c, hw in _k5_bf16_tile_shapes()])
def test_batched_k5_matches_twin_and_batch_1(dev, restore_mode, form, c, hw,
                                             batch):
    """K5 at a batch (the image is the grid's z; at C = 48 and 192 the
    batch's tiles taken by thread-block clusters, the resident ones
    striding over them, each keeping its weights from its first), f32
    and both one-pass forms, forward and reverse: against the twin (f32:
    2e-4; one-pass: max 2e-2 and mean 1e-4, a tie flip), a second launch
    bit for bit the first, and each image bit for bit its own batch-1
    launch."""
    step = random_flow_step(c, seed=c)
    pt = step.kpacked.to(dev)
    pb = None if form is None else flow_step.pack_step_bf16(
        step.actnorm, step.invconv, step.affine, form).to(dev)
    xt, rt = _k5_batch(c, hw, batch, dev)
    restore_mode.set_default_precision("high" if form is None else "default")
    name = ("flow_step" if form is None else "flow_step_bf16" if form == "xla"
            else "flow_step_bf16_pallas")
    kcuda.reset_launch_counts()
    y = flow_step.flow_step_forward(xt, rt, pt, 64, pb, form or "xla")
    back = flow_step.flow_step_reverse(y, rt, pt, 64, pb, form or "xla")
    assert kcuda.LAUNCHES[f"{name}_forward"] == 1, kcuda.LAUNCHES
    assert kcuda.LAUNCHES[f"{name}_reverse"] == 1, kcuda.LAUNCHES
    assert y.shape == back.shape == (batch, *hw, c)
    assert torch.equal(y, flow_step.flow_step_forward(xt, rt, pt, 64, pb,
                                                      form or "xla"))
    assert torch.equal(back, flow_step.flow_step_reverse(y, rt, pt, 64, pb,
                                                         form or "xla"))
    if form is None:
        torch.testing.assert_close(
            y, flow_step.flow_step_forward_plain(xt, rt, pt, 64),
            atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(
            back, flow_step.flow_step_reverse_plain(y, rt, pt, 64),
            atol=2e-4, rtol=2e-4)
    else:
        fwd = flow_step.BF16_FORMS[form, False][1]
        rev = flow_step.BF16_FORMS[form, True][1]
        for got, twin in ((y, fwd(xt, rt, pb, 64)), (back, rev(y, rt, pb, 64))):
            err = (got - twin).abs()
            assert torch.isfinite(got).all()
            assert float(err.max()) <= 2e-2, float(err.max())
            assert float(err.mean()) <= 1e-4, float(err.mean())
    for i in range(batch):
        xi, ri = xt[i:i + 1], rt[i:i + 1]
        assert torch.equal(y[i:i + 1], flow_step.flow_step_forward(
            xi, ri, pt, 64, pb, form or "xla")), i
        assert torch.equal(back[i:i + 1], flow_step.flow_step_reverse(
            y[i:i + 1], ri, pt, 64, pb, form or "xla")), i


def test_k5_wrapper_raises_on_a_batch_it_does_not_take(dev):
    step = random_flow_step(12)
    x = torch.zeros((2, 4, 4, 12), device=dev)
    with pytest.raises(ValueError):   # one record per image
        flow_step.flow_step_forward(
            x, torch.zeros((1, 4, 4, 2 * 12 + 64), device=dev),
            step.kpacked.to(dev), 64)
    with pytest.raises(ValueError):   # the batch is the grid's z
        flow_step.flow_step_forward(
            torch.zeros((65536, 1, 1, 12), device=dev),
            torch.zeros((65536, 1, 1, 2 * 12 + 64), device=dev),
            step.kpacked.to(dev), 64)


@pytest.mark.parametrize("form", [None, "xla"])
@pytest.mark.parametrize("c,hw", [(12, (40, 33)), (24, (20, 13)),
                                  (96, (10, 10)), (48, (20, 13)),
                                  (192, (10, 10))])
def test_flow_step_reverse_gradient_on_the_card(dev, restore_mode, form, c,
                                                hw):
    """FlowStepReverse: K5's reverse forward (one launch) and the gradient
    of the twin in the same form, against autograd through that twin
    (``flow_step_reverse_twin``) on the card.  Both differentiate the same
    twin at the same state; the library's sums may run in another order,
    which in the one-pass form can flip a gradient's bf16 rounding at a
    tie (max 2e-2, mean 1e-4, as the one-pass kernels)."""
    step = random_flow_step(c, seed=c)
    pt, pb = step.kpacked.to(dev), step.kpacked_bf16.to(dev)
    xt, rt = _k5_batch(c, hw, 3, dev, seed=2)
    up = _t(_gen(c).standard_normal((3, *hw, c)), dev)
    restore_mode.set_default_precision("high" if form is None else "default")
    name = "flow_step_reverse" if form is None else "flow_step_bf16_reverse"
    before = kcuda.LAUNCHES[name]
    x = xt.clone().requires_grad_(True)
    y = flow_step.flow_step_reverse_diff(x, rt, pt, 64, pb)
    assert kcuda.LAUNCHES[name] == before + 1
    (gx,) = torch.autograd.grad(y, x, up)
    xr = xt.clone().requires_grad_(True)
    yr = flow_step.flow_step_reverse_twin(xr, rt, pt, 64, pb)
    (gr,) = torch.autograd.grad(yr, xr, up)
    tol = 2e-4 if form is None else 2e-2
    assert float((y.detach() - yr.detach()).abs().max()) <= tol
    if form is None:
        torch.testing.assert_close(gx, gr, rtol=0,
                                   atol=1e-5 * float(gr.abs().max()))
    else:
        err = (gx - gr).abs()
        assert float(err.max()) <= 2e-2, float(err.max())
        assert float(err.mean()) <= 1e-4, float(err.mean())


def test_small_srflow_prior_step_kernel_path_matches_twin_path(dev):
    """One SRFlow-LP prior train step at the smallest size the kernels
    take (RRDB nf 16 x 2 blocks, gc 16; K 2, hidden 64; prior depth 2 /
    dim 16; B 3 of 64^2 GT) with both losses, on the kernel path and on
    the twin path from the same state: K3 on the RRDB's 30 dense-block
    convs, K5 12 forward (both encodes) and 6 reverse (the decode); the
    losses within 1e-4 relative and the gradients, as one vector, within
    1e-2 relative L2 (the step's gradients move by ~2e-5 in relative L2
    under a 1e-6 relative change of its inputs at this size, on the CPU)."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import example_srflow_train_batch
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.srflow_prior_train import (
        make_srflow_prior_train_step)
    from bfsr_tpu_torch.train.optim import make_optimizer

    model = registry.make({"name": "srflow", "args": {
        "nf": 16, "nb": 2, "gc": 16, "K": 2, "L": 3, "hidden_channels": 64,
        "stack_blocks": (0, 1)}})
    model.reset_parameters(seeded(3))
    model = model.to(dev).eval().freeze()
    prior = registry.make({"name": "srflow-unet",
                           "args": {"depth": 2, "dim": 16}}).to(dev).train()
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    batch = example_srflow_train_batch(dev, 0, batch=3, gt_size=64)
    kcuda.reset_launch_counts()
    mets, grads, _ = make_srflow_prior_train_step(
        model, prior, opt, 1.0, 1.0).loss_and_grads(batch)
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": 30, "flow_step_forward": 12,
        "flow_step_reverse": 6}, kcuda.LAUNCHES
    kcuda.reset_launch_counts()
    ref_mets, ref_grads, _ = make_srflow_prior_train_step(
        model, prior, opt, 1.0, 1.0, kernels=False).loss_and_grads(batch)
    assert not any(kcuda.LAUNCHES.values()), kcuda.LAUNCHES
    for k in mets:
        torch.testing.assert_close(mets[k], ref_mets[k], rtol=1e-4, atol=0)
    g = torch.cat([v.flatten() for v in grads.values()])
    r = torch.cat([ref_grads[k].flatten() for k in grads])
    assert torch.isfinite(g).all()
    assert float((g - r).norm() / r.norm()) <= 1e-2


# --- the evaluation slice: validation at each query's own coordinate and
# the SRFlow-LP predictor's pad_multiple ---------------------------------


def test_per_query_predict_kernel_path_matches_twin_path(dev):
    """``LINFPredictor.predict`` on a val-like batch (4 crops of 16^2 LR, random
    HR query subsets): K3 43 (the encoder's 34 and the prior's 9 convs at
    B 4), K1 once each way over the 1,024 queries, no K2; the image within
    1e-3 of the twin path."""
    from bfsr_tpu_torch.entry import build_flagship
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor, is_grid

    model, prior = build_flagship(dev, seed=0)
    g = _gen(5)
    B, n, H = 4, 16, 48
    coord = np.empty((B, n, n, 2), np.float32)
    for b in range(B):
        yy, xx = np.divmod(g.choice(H * H, n * n, replace=False), H)
        coord[b] = np.stack([-1 + (2 * yy + 1) / H, -1 + (2 * xx + 1) / H],
                            -1).reshape(n, n, 2)
    args = (_t(g.uniform(-1, 1, (B, n, n, 3)), dev), _t(coord, dev),
            _t(np.full((B, 2), 2.0 / H), dev),
            _t(0.1 * g.standard_normal((B, n, n, 3)), dev))
    assert not is_grid(args[1])
    kcuda.reset_launch_counts()
    got = LINFPredictor(model, prior).predict(*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": 43, "linf_flow_forward": 1,
        "linf_flow_inverse": 1}, kcuda.LAUNCHES
    ref = LINFPredictor(model, prior, kernels=False).predict(*args)
    assert got.shape == (B, n, n, 3) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


def test_srflow_predictor_pad_multiple_8_kernel_path_matches_twin_path(dev):
    """``SRFlowLPPredictor(pad_multiple=8)`` on an LR of 13x10 (padded to
    16x16 with the image's mirror, the SR cropped back to 52x40), at a
    small flow (RRDB nf 16 x 2, K 2, hidden 64) and the flagship prior:
    K5 on every conditional step both ways, the image within 5e-3 of the
    twin path."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import srflow_specs
    from bfsr_tpu_torch.models.base import seeded
    from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor

    model = registry.make({"name": "srflow", "args": {
        "nf": 16, "nb": 2, "gc": 16, "K": 2, "L": 3, "hidden_channels": 64,
        "stack_blocks": (0, 1)}})
    model.reset_parameters(seeded(3))
    model = model.to(dev).eval().freeze()
    prior = registry.make(srflow_specs()[1])
    prior.reset_parameters(seeded(4))
    prior = prior.to(dev).eval().freeze()
    lr = _t(_gen(6).random((13, 10, 3)), dev)
    kcuda.reset_launch_counts()
    got = SRFlowLPPredictor(model, prior, pad_multiple=8).predict(lr)
    torch.cuda.synchronize()
    assert kcuda.LAUNCHES["flow_step_forward"] == 6, kcuda.LAUNCHES
    assert kcuda.LAUNCHES["flow_step_reverse"] == 6, kcuda.LAUNCHES
    ref = SRFlowLPPredictor(model, prior, kernels=False,
                            pad_multiple=8).predict(lr)
    assert got.shape == (52, 40, 3) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=5e-3)


# --- SRFlow base-model training and validation ---------------------------


def _small_srflow(dev):
    """The smallest SRFlow the kernels take (RRDB nf 16 x 2 blocks, gc 16;
    K 2, hidden 64), live random weights, frozen on ``dev``."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.models.base import seeded

    model = registry.make({"name": "srflow", "args": {
        "nf": 16, "nb": 2, "gc": 16, "K": 2, "L": 3, "hidden_channels": 64,
        "stack_blocks": (0, 1)}})
    model.reset_parameters(seeded(3))
    return model.to(dev).freeze()


def _base_step(model, **kw):
    from bfsr_tpu_torch.pipelines.srflow_train import make_srflow_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         model.parameters())
    return make_srflow_train_step(model, opt, **kw)


def test_frozen_phase_rrdb_on_k3_matches_twin_path(dev):
    """The base trainer's frozen-phase step at B 2 of 64^2 GT: the RRDB's
    30 dense-block convs on K3, no K5 (the trained flow runs unfused); its
    loss within 1e-4 relative of the twin path's from the same state and
    noise, and the gradients, as one vector, within 1e-2 relative L2, as
    the prior trainer's small step is held."""
    from bfsr_tpu_torch.entry import example_srflow_train_batch

    model = _small_srflow(dev)
    batch = example_srflow_train_batch(dev, 0, batch=2, gt_size=64)
    noise = (torch.rand(batch["GT"].shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
             - 0.5) / 32
    kcuda.reset_launch_counts()
    mets, grads = _base_step(model, freeze_rrdb=True,
                             weight_l1=0.5).loss_and_grads(batch, 0, noise)
    torch.cuda.synchronize()
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": 30}, kcuda.LAUNCHES
    kcuda.reset_launch_counts()
    ref, ref_grads = _base_step(model, freeze_rrdb=True, weight_l1=0.5,
                                kernels=False).loss_and_grads(batch, 0, noise)
    assert not any(kcuda.LAUNCHES.values()), kcuda.LAUNCHES
    for k in mets:
        torch.testing.assert_close(mets[k], ref[k], rtol=1e-4, atol=0)
    g = torch.cat([v.flatten() for v in grads.values()])
    r = torch.cat([ref_grads[k].flatten() for k in grads])
    assert torch.isfinite(g).all()
    assert float((g - r).norm() / r.norm()) <= 1e-2
    assert not any(grads[k].any() for k in grads if k.startswith("RRDB."))


def test_validate_k5_decode_at_heat_half_matches_twin_path(dev):
    """``validate`` at heat 0.5 with its seeded generator on the card: K3
    30 and K5 6 reverse a sample (no K5 forward: the NLL runs unfused);
    the sample within 5e-3 of the twin path's (the same draws), the NLL
    within 1e-4 relative."""
    from bfsr_tpu_torch.entry import example_srflow_train_batch
    from bfsr_tpu_torch.pipelines.srflow_eval import validate

    model = _small_srflow(dev)
    batch = example_srflow_train_batch(dev, 1, batch=1, gt_size=64)
    kcuda.reset_launch_counts()
    nll, samples = validate(model, [batch], heats=(0.5,), n_sample=1)
    torch.cuda.synchronize()
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": 30, "flow_step_reverse": 6}, kcuda.LAUNCHES
    ref_nll, ref = validate(model, [batch], heats=(0.5,), n_sample=1,
                            kernels=False)
    assert np.isfinite(nll) and abs(nll - ref_nll) <= 1e-4 * abs(ref_nll)
    torch.testing.assert_close(samples[0.5, 0], ref[0.5, 0], rtol=0,
                               atol=5e-3)


def test_kernel_layouts_older_than_the_weights_raise(dev):
    """After a live step moves the RRDB and the flow, the K3 and K5 paths
    refuse the layouts of the last ``freeze()``; a new ``freeze()`` lays
    them out again."""
    from bfsr_tpu_torch.entry import example_srflow_train_batch

    model = _small_srflow(dev)
    batch = example_srflow_train_batch(dev, 2, batch=2, gt_size=64)
    _base_step(model, rrdb_unfreeze_step=0)(batch, 0)
    lq = batch["LQ"]
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="older than its weights"):
            model.rrdb_preprocess(lq)
        cache = model.precompute_ft(model.rrdb_preprocess(lq, kernels=False))
        with pytest.raises(RuntimeError, match="older than its weights"):
            model.normal_flow(batch["GT"], cache)
        model.freeze()
        cache = model.precompute_ft(model.rrdb_preprocess(lq))
        assert torch.isfinite(model.normal_flow(batch["GT"], cache)[-1]).all()


def _small_linf_spec(encoder_spec):
    """A LINF at K2's hidden 128 (the smallest it takes) on
    ``encoder_spec``, flow L 3."""
    return {"name": "linf", "args": {
        "encoder_spec": encoder_spec,
        "imnet_spec": {"name": "flow", "args": {"name": "flow"}},
        "flow_layers": 3, "num_layer": 2, "hidden_dim": 128}}


def _grid_args(dev, g, h, w, s):
    from bfsr_tpu_torch.utils.coords import make_cell, make_coord

    H, W = h * s, w * s
    return (_t(g.uniform(-1, 1, (1, h, w, 3)), dev),
            _t(make_coord((H, W), flatten=False)[None], dev),
            _t(make_cell((H, W))[None], dev),
            _t(0.1 * g.standard_normal((1, H, W, 3)), dev))


@pytest.mark.parametrize("prior_name", ["unet", "edsr-baseline-latent"])
def test_rrdb_linf_and_edsr_latent_predict_kernel_path_matches_twin_path(
        dev, prior_name):
    """An RRDB-encoder LINF (nf 16, nb 2, gc 16: K3 30) with a UNet prior
    (K3 9) or ``edsr-baseline-latent`` (2 blocks: K3 10 + 4), 24x20 ->
    72x60: the launches, the image within 1e-3 of the twin path."""
    from bfsr_tpu_torch.entry import build_linf
    from bfsr_tpu_torch.pipelines.linf_eval import LINFPredictor

    rrdb = {"name": "rrdb", "args": {"nf": 16, "nb": 2, "gc": 16,
                                     "no_upsampling": True}}
    pspec = ({"name": "unet", "args": {"in_chans": 3, "depth": 2,
                                       "dim": 16}}
             if prior_name == "unet" else
             {"name": "edsr-baseline-latent",
              "args": {"in_chans": 3, "n_resblocks": 2}})
    model, prior = build_linf(_small_linf_spec(rrdb), pspec, dev, seed=0)
    args = _grid_args(dev, _gen(6), 24, 20, 3)
    kcuda.reset_launch_counts()
    got = LINFPredictor(model, prior).predict(*args)
    torch.cuda.synchronize()
    k3 = 30 + (9 if prior_name == "unet" else 14)
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": k3, "linf_info": 1, "linf_flow_forward": 1,
        "linf_flow_inverse": 1}, kcuda.LAUNCHES
    ref = LINFPredictor(model, prior, kernels=False).predict(*args)
    assert got.shape == (1, 72, 60, 3) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


def test_swin_prior_step_kernel_path_matches_twin_path(dev):
    """One step with the Swin prior (stochastic depth 0.1) on a small EDSR
    LINF, B 2 of 16^2 crops: the kernel path and the twin path from the
    same generator state give the same loss within 1e-5 and gradients
    within 1e-3 relative L2; the next draw gives another loss."""
    from bfsr_tpu_torch import registry
    from bfsr_tpu_torch.entry import (SWIN_PRIOR, build_linf,
                                      example_train_batch, he_normal_vgg)
    from bfsr_tpu_torch.pipelines.linf_train import make_train_step
    from bfsr_tpu_torch.train.optim import make_optimizer

    edsr = {"name": "edsr-baseline", "args": {"n_resblocks": 2,
                                              "n_feats": 16,
                                              "no_upsampling": True}}
    model, prior = build_linf(_small_linf_spec(edsr), SWIN_PRIOR, dev, 0)
    prior.train()
    vgg = he_normal_vgg(dev, seed=0, tiny=True)
    batch = example_train_batch(dev, seed=0, batch=2, inp_size=16)
    opt = make_optimizer({"name": "adam", "args": {"lr": 1e-4}},
                         prior.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = [make_train_step(model, prior, vgg, opt, kernels=k,
                             generator=gen) for k in (True, False)]
    state = gen.get_state()
    kcuda.reset_launch_counts()
    kmets, kgrads, _ = steps[0].loss_and_grads(batch)
    torch.cuda.synchronize()
    assert {k: v for k, v in kcuda.LAUNCHES.items() if v} == {
        "conv3x3_cat": 6, "linf_info": 1, "linf_flow_forward": 1,
        "linf_flow_inverse": 1}, kcuda.LAUNCHES
    gen.set_state(state)
    mets, grads, _ = steps[1].loss_and_grads(batch)
    torch.testing.assert_close(kmets["loss"], mets["loss"], rtol=1e-5,
                               atol=0)
    g = torch.cat([v.flatten() for v in kgrads.values()])
    r = torch.cat([grads[k].flatten() for k in kgrads])
    assert float((g - r).norm() / r.norm()) < 1e-3
    assert registry.lookup("swin_latent") is type(prior)
    assert not torch.equal(steps[0].loss_and_grads(batch)[0]["loss"],
                           kmets["loss"])


def test_dp_wrappers_at_world_1_on_nccl(dev, tmp_path):
    """The three dp steps (the LINF-LP pixel step, the SRFlow-LP prior
    step, the SRFlow base model's frozen step) through the dp wrappers on
    one NCCL rank on this card, at the flagship widths and small batches,
    against the same steps on one process (``check_against_single``: the
    loss within 1e-5, the gradients held as ``chip_smoke.py`` phase 17
    holds them: twice the step's worst spread under a 1e-7 nudge of its
    input, at least 1e-3); each rank's launches those of the single
    step."""
    from bfsr_tpu_torch.entry import (example_srflow_train_batch,
                                      example_train_batch)
    from bfsr_tpu_torch.parallel.mesh import spawn
    from bfsr_tpu_torch.parallel.sharded import (check_against_single,
                                                 run_cases)

    def host(d):
        return {k: v.numpy() for k, v in d.items()}

    seed = {"seed": 0}
    cases = [
        {"step": "linf", "recipe": seed, "mesh": {"dp": 1},
         "batch": host(example_train_batch("cpu", 1, 2, 16)),
         "opts": {"vgg_weight": 1.0, "latent_weight": 1.0}},
        {"step": "srflow_prior", "recipe": seed, "mesh": {"dp": 1},
         "batch": host(example_srflow_train_batch("cpu", 2, 2, 64)),
         "opts": {"eps_weight": 1.0, "image_weight": 1.0}},
        {"step": "srflow_nll", "recipe": dict(seed, prime=True),
         "mesh": {"dp": 1},
         "batch": host(example_srflow_train_batch("cpu", 3, 2, 64)),
         "opts": {"freeze_rrdb": True}}]
    ranks = spawn(run_cases, 1, "nccl", args=(cases, "cuda"),
                  store_dir=tmp_path,
                  init_timeout=120.0, join_timeout=900.0, device="cuda:0")
    for i, case in enumerate(cases):
        got = ranks[0][i]
        single = run_cases([dict(case, mesh=None)], "cuda")[0]
        assert got["launches"] == single["launches"], case["step"]
        print(check_against_single(case, [got], f"nccl world 1 "
                                   f"{case['step']}", "cuda"))
