"""One image's width sharded over ranks (``SRFlowSpatialPredictor``, the
halo exchange of ``ops/halo.py``) on the CPU over gloo.

Every sharded case runs in one spawn of four ranks
(``parallel.spatial_checks.run``; a case at n ranks runs on the first n)
while the JAX side runs here:

* the exchange alone at n = 2, 3 and 4 and r = 1 and 2: each rank's
  haloed strip is the whole tensor's slice, with no column at the image's
  true edges; strips of unequal widths raise on every rank;
* each op with a spatial extent under ``width_sharded`` at n = 2 and 4
  against the op on the whole tensor, within 1e-6: a 3x3 and a 1x1
  ``fnn.conv2d``, a grouped 3x3 through ``halo.apply``, K3's entry and
  twin over 3 inputs, the conditioning records, K5's entry and twin
  forward and reverse in f32 and in the served (``xla``) one-pass form
  and the unfused step, each on records made inside the scope, the
  resizes (bilinear up x4, down /2 and /4; nearest x2 and /2),
  ``_upsample_to`` (``align_corners=True``: the naive local resize of a
  haloed strip is shown to miss), the pool and the squeezes;
* the whole predictor: the tiny SRFlow of ``tests/test_sharded.py`` (nf
  8, nb 2, gc 4, K 2, L 3, hidden 8) and a ``srflow-unet`` prior of depth 2
  and dim 8, the JAX weights carried over with ``convert/from_jax.py``
  (``tiny_pair``), at LR 16 x 32 and a ragged 18 x 37 on n = 2 (a dp 2 x
  sp 2 mesh: both dp replicas predict) and 16 x 64 on n = 4, with
  ``kernels=TWINS`` and ``False``: each rank's SR strip within 1e-5 of
  the port's ``SRFlowLPPredictor.run`` on the same padded LR, and the
  gathered image within 5e-3 of the JAX ``SRFlowSpatialPredictor`` on a
  ``make_mesh({'sp': n})`` of the virtual CPU devices (the port's
  SRFlow-LP image tolerance against JAX).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from bfsr_tpu.parallel.mesh import make_mesh as j_make_mesh
from bfsr_tpu.pipelines.srflow_eval import (
    SRFlowSpatialPredictor as JSpatialPredictor)
from bfsr_tpu_torch.models.unet import _upsample_to
from bfsr_tpu_torch.ops import flows
from bfsr_tpu_torch.ops import nn as fnn
from bfsr_tpu_torch.ops.cuda import TWINS
from bfsr_tpu_torch.ops.cuda.conv3x3 import conv3x3_cat_twin
from bfsr_tpu_torch.ops.cuda.flow_step import (flow_step_forward_twin,
                                               flow_step_reverse_twin)
from bfsr_tpu_torch.ops.interp import resize_bilinear, resize_nearest
from bfsr_tpu_torch.ops import halo
from bfsr_tpu_torch.parallel.mesh import spawn
from bfsr_tpu_torch.parallel.sharded import (STRIP_TOL, compare_strips,
                                             run_cases, state_of)
from bfsr_tpu_torch.parallel.spatial_checks import flow_steps, run, strip

from test_torch_srflow_models import tiny_pair

SPAWN = {"init_timeout": 60.0, "join_timeout": 240.0, "threads": 1}
SITE_TOL, JAX_TOL = 1e-6, 5e-3
STEP = {"c": 12, "c_cond": 5, "hidden": 8, "seed": 3}
# (label, LR (h, w), ranks, mesh)
PREDICTS = [("16x32 n2", (16, 32), 2, {"dp": 2, "sp": 2}),
            ("16x64 n4", (16, 64), 4, {"sp": 4}),
            ("ragged 18x37 n2", (18, 37), 2, {"dp": 2, "sp": 2})]
KERNELS = {"twins": TWINS, "unfused": False}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _site_cases():
    """{id: case} of the sites at n = 2 and 4."""
    rng = np.random.default_rng(7)
    x16 = _rand(rng, 1, 5, 16, 3)
    k3_xs = [_rand(rng, 1, 5, 16, c) for c in (3, 2, 4)]
    step = {"x": _rand(rng, 1, 6, 16, STEP["c"]),
            "ft": _rand(rng, 1, 6, 16, STEP["c_cond"]), **STEP}
    base = {
        "conv2d 3x3": {"site": "conv2d", "x": x16,
                       "w": _rand(rng, 4, 3, 3, 3) * 0.3,
                       "b": _rand(rng, 4)},
        "conv2d 1x1": {"site": "conv2d", "x": x16,
                       "w": _rand(rng, 4, 3, 1, 1), "b": _rand(rng, 4)},
        "grouped 3x3": {"site": "grouped", "x": _rand(rng, 1, 5, 16, 4),
                        "w": _rand(rng, 6, 2, 3, 3) * 0.3, "groups": 2},
        "records": {"site": "records", "ft": step["ft"], "n_steps": 2,
                    **STEP},
        "resize up x4": {"site": "resize", "x": _rand(rng, 1, 3, 8, 2),
                         "out_hw": (12, 32), "align_corners": False,
                         "nearest": False},
        "resize down /2": {"site": "resize", "x": _rand(rng, 1, 8, 32, 2),
                           "out_hw": (4, 16), "align_corners": False,
                           "nearest": False},
        "resize down /4": {"site": "resize", "x": _rand(rng, 1, 8, 32, 2),
                           "out_hw": (2, 8), "align_corners": False,
                           "nearest": False},
        "nearest x2": {"site": "resize", "x": _rand(rng, 1, 3, 8, 2),
                       "out_hw": (6, 16), "align_corners": False,
                       "nearest": True},
        "nearest /2": {"site": "resize", "x": _rand(rng, 1, 8, 32, 2),
                       "out_hw": (4, 16), "align_corners": False,
                       "nearest": True},
        "upsample_to": {"site": "upsample_to", "x": _rand(rng, 1, 3, 8, 2)},
        "pool": {"site": "pool", "x": _rand(rng, 1, 4, 16, 3)},
        "squeeze": {"site": "squeeze", "x": _rand(rng, 1, 4, 16, 3)},
        "unsqueeze": {"site": "unsqueeze", "x": _rand(rng, 1, 4, 16, 12)},
    }
    for fn in ("kernel", "twin"):
        base[f"k3 {fn}"] = {"site": "k3", "xs": k3_xs, "fn": fn,
                            "w": _rand(rng, 4, 9, 3, 3) * 0.2,
                            "scale": _rand(rng, 4), "bias": _rand(rng, 4),
                            "act": "lrelu"}
    for fn, mode in (("kernel", "high"), ("kernel", "default"),
                     ("twin", "high"), ("twin", "default"),
                     ("unfused", "high")):
        for reverse in (False, True):
            base[f"step {fn} {mode} {'rev' if reverse else 'fwd'}"] = {
                "site": "step", "fn": fn, "mode": mode, "reverse": reverse,
                **step}
    return {f"{k} n{n}": dict(c, n=n) for k, c in base.items()
            for n in (2, 4)}


SITES = _site_cases()


def _exchange_cases():
    x = np.arange(3 * 12 * 2, dtype=np.float32).reshape(1, 3, 12, 2)
    return {f"n{n} r{r}": {"site": "exchange", "x": x, "r": r, "n": n}
            for n in (2, 3, 4) for r in (1, 2)}


EXCHANGES = _exchange_cases()
UNEQUAL = {"site": "unequal", "x": np.zeros((1, 2, 8, 1), np.float32),
           "n": 2}


def _predict_cases(recipe):
    rng = np.random.default_rng(11)
    cases = {}
    for label, hw, n, mesh in PREDICTS:
        lr = rng.random((*hw, 3)).astype(np.float32)
        for name, k in KERNELS.items():
            cases[label, name] = {
                "predict": "srflow_sp", "recipe": recipe,
                "inputs": {"lr": lr}, "mesh": mesh,
                "opts": {"kernels": k}}
    return cases


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """Every case's ranks (one spawn at world 4) and the JAX spatial
    predictor's image of each predict's LR, computed while the ranks
    run."""
    jm, jp, tm, tp = tiny_pair()
    predicts = _predict_cases({"srflow": state_of(tm),
                               "prior": state_of(tp)})
    keys = ([("exchange", k) for k in EXCHANGES] + [("unequal", None)]
            + [("site", k) for k in SITES]
            + [("predict", k) for k in predicts])
    cases = ([*EXCHANGES.values(), UNEQUAL, *SITES.values()]
             + list(predicts.values()))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, run, 4, "gloo", args=(cases, "cpu"),
                            store_dir=tmp_path_factory.mktemp("w4"), **SPAWN)
        jax_images = {}
        for label, _, n, _ in PREDICTS:
            lr = predicts[label, "twins"]["inputs"]["lr"]
            pred = JSpatialPredictor(jm, jp, j_make_mesh({"sp": n}))
            jax_images[label] = pred.predict(lr)
        ranks = ranks.result()
    by = {key: [r[i] for r in ranks] for i, key in enumerate(keys)}
    return by, predicts, jax_images


# --- the exchange ---------------------------------------------------------


@pytest.mark.parametrize("key", list(EXCHANGES))
def test_exchange_is_the_whole_slice(spatial, key):
    """Rank i's haloed strip is columns [i w - r, (i + 1) w + r) of the
    whole tensor, cut at the image's edges."""
    by, _, _ = spatial
    case = EXCHANGES[key]
    n, r = case["n"], case["r"]
    for i in range(n):
        want = strip(torch.as_tensor(case["x"]), i, n, r).numpy()
        got = by["exchange", key][i]
        assert got.shape == want.shape, (key, i, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{key} rank {i}")
    assert all(v is None for v in by["exchange", key][n:])


def test_unequal_strips_raise_on_every_rank(spatial):
    by, _, _ = spatial
    for msg in by["unequal", None][:2]:
        assert "differ in width" in msg, msg


def test_narrow_strip_and_odd_strips_raise():
    """A strip narrower than its halo raises before any collective, and
    the local ops refuse a strip they would pair across its edge."""
    x = torch.zeros((1, 4, 3, 2))
    with pytest.raises(ValueError, match="narrower"):
        halo.exchange(x[:, :, :1], 2, None, 0, 2)
    with fnn.width_sharded(None, 0, 2):
        with pytest.raises(ValueError, match="pool"):
            fnn.max_pool2d(x, 2)
        with pytest.raises(ValueError, match="squeeze"):
            flows.squeeze2d(x)


# --- each site ------------------------------------------------------------


def _whole(case):
    """The op of a site case on the whole tensor, one process."""
    a = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in case.items()}
    site = a["site"]
    if site == "conv2d":
        return fnn.conv2d(a["x"], a["w"], a["b"])
    if site == "grouped":
        return fnn.nchw_to_nhwc(torch.nn.functional.conv2d(
            fnn.nhwc_to_nchw(a["x"]), a["w"], padding=1, groups=a["groups"]))
    if site == "k3":
        return conv3x3_cat_twin([torch.as_tensor(x) for x in a["xs"]],
                                a["w"], a["scale"], a["bias"], a["act"])
    if site == "records":
        steps = flow_steps(a["c"], a["c_cond"], a["hidden"], a["n_steps"],
                           a["seed"])
        return torch.stack(flows.cond_affine_cache_batched(
            a["ft"], [m.affine for m in steps]))
    if site == "step":
        (m,) = flow_steps(a["c"], a["c_cond"], a["hidden"], 1, a["seed"])
        saved = fnn.precision_mode()
        fnn.set_default_precision(a["mode"])
        try:
            (rec,) = flows.cond_affine_cache_batched(a["ft"], [m.affine])
            if a["fn"] == "unfused":
                return (m.reverse_step(a["x"], rec, False) if a["reverse"]
                        else m.forward_step(a["x"], rec, False))
            fn = flow_step_reverse_twin if a["reverse"] else \
                flow_step_forward_twin
            return fn(a["x"], rec, m.kpacked, m.hidden, m.kpacked_bf16,
                      m.step_form)
        finally:
            fnn.set_default_precision(saved)
    x = a["x"]
    if site == "resize":
        return (resize_nearest(x, a["out_hw"]) if a["nearest"]
                else resize_bilinear(x, a["out_hw"], a["align_corners"]))
    if site == "upsample_to":
        return _upsample_to(x, (2 * x.shape[1], 2 * x.shape[2]))
    if site == "pool":
        return fnn.max_pool2d(x, 2)
    if site == "squeeze":
        return flows.squeeze2d(x)
    return flows.unsqueeze2d(x)


@pytest.mark.parametrize("key", list(SITES))
def test_site_matches_whole_op(spatial, key):
    by, _, _ = spatial
    case = SITES[key]
    with torch.no_grad():
        want = _whole(case).numpy()
    got = np.concatenate(by["site", key][:case["n"]], axis=-2)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=SITE_TOL, rtol=0,
                               err_msg=key)


@pytest.mark.parametrize("n", [2, 4])
def test_naive_upsample_to_misses(n):
    """A local x2 resize at ``align_corners=True`` of a strip with one
    column of each neighbour, cropped, is not the whole resize's strip:
    its source positions j (W - 1) / (2 W - 1) depend on the whole
    width."""
    x = torch.as_tensor(SITES[f"upsample_to n{n}"]["x"])
    want = _upsample_to(x, (2 * x.shape[1], 2 * x.shape[2]))
    w = x.shape[2] // n
    parts = []
    for i in range(n):
        left, right = halo.sides(1, i, n)
        h = strip(x, i, n, 1)
        y = resize_bilinear(h, (2 * h.shape[1], 2 * h.shape[2]),
                            align_corners=True)
        parts.append(y[:, :, 2 * left:2 * (left + w)])
    naive = torch.cat(parts, 2)
    assert naive.shape == want.shape
    assert float((naive - want).abs().max()) > 1e-2


# --- the predictor ---------------------------------------------------------


@pytest.mark.parametrize("kernels", list(KERNELS))
@pytest.mark.parametrize("label", [p[0] for p in PREDICTS])
def test_spatial_predict_matches_single_and_jax(spatial, label, kernels):
    """Each rank's SR strip (``run``) is the single predict's columns of
    the same padded LR, every rank's gathered image is the single one's,
    and it is the JAX spatial predictor's."""
    by, predicts, jax_images = spatial
    case = predicts[label, kernels]
    n = case["mesh"]["sp"]
    single = run_cases([dict(case, mesh=None,
                             opts=dict(case["opts"], sp=n))], "cpu")[0]
    ranks = by["predict", (label, kernels)]
    h, w = case["inputs"]["lr"].shape[:2]
    # each dp replica's n ranks hold the image's n strips
    for d in range(0, len(ranks), n):
        compare_strips(single, ranks[d:d + n], f"{label} ranks {d}-")
    for got in ranks:
        assert got["image"].shape == (4 * h, 4 * w, 3)
        np.testing.assert_allclose(got["image"], single["image"],
                                   atol=STRIP_TOL, rtol=0)
        assert got["exchanges"] > 0 and not got["launches"]
    np.testing.assert_allclose(ranks[0]["image"], np.asarray(
        jax_images[label]), atol=JAX_TOL, rtol=0, err_msg=label)
