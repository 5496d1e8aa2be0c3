"""The port's sharded steps and predicts on the CPU over gloo: the
counterpart of each case of ``tests/test_sharded.py`` (which runs the JAX
ones on an 8-device virtual mesh), plus ``dryrun_multichip(2)`` and the
two-process loader-fed ``multiproc_dryrun``.

Each sharded case runs in ranks started by ``parallel.mesh.spawn`` (a
``file://`` store under the test's temporary directory, an init timeout
and a join timeout) and is held two ways:

* against the same work on one process of the port
  (``parallel.sharded.check_against_single``): the loss within 1e-5
  relative, the gradients within 1e-5 relative L2 (each tensor and all as
  one vector; where the single-process step's own gradients move more
  than that under a 1e-7 nudge of its input, within twice that move:
  the SRFlow-LP prior's second branch), the parameters after one Adam
  step within 1e-3, as ``tests/test_sharded.py:86-91``; a predict's
  images within 1e-5;
* against the JAX step or predictor on the same numpy inputs and weights,
  computed here (``bfsr_tpu_torch/PARITY.md``'s rows): the loss within
  1e-5 relative and each gradient within 1e-4 of its tensor's largest
  value; LINF-LP's images within 2e-4 (the dp predict 1e-4, as the JAX
  test holds it), SRFlow-LP's within 5e-3.

The steps: the LINF-LP dp x sp step at world 4 (dp 2 x sp 2: B 4 of 6^2
LR, the 12^2 HR rows split), the SRFlow NLL dp step (B 8 of 16^2 GT, the
JAX step's quantisation noise) and the SRFlow-LP prior dp step (B 4 of
64^2 GT: ``tests/test_torch_srflow_prior_train.py`` says why not 32^2),
both at world 2.  The predicts at world 2: the query-sharded LINF-LP
predict with its prior (12 x 16 HR rows split), the dp LINF-LP predict
(4 images, 2 a rank; its PSNR over both ranks) and the dp SRFlow-LP
predict (one LR a rank).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

import bfsr_tpu.models  # noqa: F401
from bfsr_tpu import registry as jregistry
from bfsr_tpu.pipelines.linf_eval import LINFPredictor as JLINFPredictor
from bfsr_tpu.pipelines.linf_train import make_train_step as j_linf_step
from bfsr_tpu.pipelines.srflow_eval import SRFlowLPPredictor as JPredictor
from bfsr_tpu.pipelines.srflow_prior_train import (
    make_srflow_prior_train_step as j_prior_step)
from bfsr_tpu.pipelines.srflow_train import (
    make_srflow_train_step as j_nll_step)
from bfsr_tpu.utils.coords import make_cell, make_coord_np
from bfsr_tpu_torch import registry
from bfsr_tpu_torch.convert.from_jax import (load_unet, load_vgg,
                                             srflow_state_dict,
                                             srflow_unet_state_dict,
                                             unet_state_dict)
from bfsr_tpu_torch.entry import dryrun_multichip, srflow_specs
from bfsr_tpu_torch.parallel.mesh import spawn
from bfsr_tpu_torch.parallel.sharded import (check_against_single, run_cases,
                                             state_of)
from bfsr_tpu_torch.profiling import multiproc_dryrun

from test_torch_predictor import _models as linf_predict_models
from test_torch_srflow_models import _np_tree, live_flow, tiny_pair
from test_torch_srflow_nll import jax_noise
from test_torch_srflow_prior_train import batch as prior_batch
from test_torch_srflow_prior_train import port_prior
from test_torch_train_parts import port_linf, small_jax_linf
from test_torch_train_step import NORM, UNET, VGG, grad_capture

SPAWN = {"init_timeout": 60.0, "join_timeout": 300.0, "threads": 1}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _hold_vs_jax(label, res, jmets, jgrads):
    """A sharded step's metrics within 1e-5 relative of the JAX step's and
    each gradient within 1e-4 of its tensor's largest value (exactly zero
    where JAX's is)."""
    for k, v in jmets.items():
        np.testing.assert_allclose(float(res["mets"][k]), v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"{label} {k}")
    assert set(res["grads"]) <= set(jgrads), label
    for name, g in res["grads"].items():
        r = np.asarray(jgrads[name])
        scale = np.abs(r).max()
        if scale == 0:
            assert not np.any(g), (label, name)
            continue
        np.testing.assert_allclose(g, r, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"{label} {name}")


def _grid_batch(rng, b, hw, s):
    """``tests/test_sharded.py``'s LINF batch: b crops of hw^2 LR on the
    regular (hw s)^2 HR grid."""
    H = hw * s
    return {"inp": rng.random((b, hw, hw, 3)).astype(np.float32),
            "coord": np.broadcast_to(make_coord_np((H, H), flatten=False)
                                     [None], (b, H, H, 2)).copy(),
            "cell": np.broadcast_to(make_cell((H, H))[None], (b, 2)).copy(),
            "gt": rng.random((b, H, H, 3)).astype(np.float32),
            "gt_lr_up": (rng.random((b, H, H, 3)) - 0.5).astype(np.float32),
            "gt_pixel": (rng.random((b, H, H, 3)) - 0.5).astype(np.float32)}


def _linf_step_case():
    """(case, a function that returns (JAX metrics, JAX gradients keyed as
    the port's)) of the LINF dp x sp step."""
    jm = small_jax_linf()
    jprior, jvgg = jregistry.make(UNET), jregistry.make(VGG)
    batch = _grid_batch(np.random.default_rng(1), 4, 6, 2)

    def jax_side():
        step = j_linf_step(jm, jprior, jvgg, grad_capture(), vgg_weight=1.0,
                           latent_weight=0.5, data_norm=NORM)
        _, grads, mets = step(jprior.params,
                              grad_capture().init(jprior.params), jm.params,
                              jvgg.params, _jb(batch))
        return ({k: float(v) for k, v in mets.items()},
                {k: v.numpy()
                 for k, v in unet_state_dict(_np(grads)).items()})

    recipe = {
        "linf": state_of(port_linf(jm)),
        "prior": state_of(load_unet(registry.make(UNET), _np(jprior.params))),
        "vgg": state_of(load_vgg(registry.make(VGG), _np(jvgg.params)))}
    case = {"step": "linf", "recipe": recipe, "batch": batch,
            "mesh": {"dp": 2, "sp": 2},
            "opts": {"vgg_weight": 1.0, "latent_weight": 0.5,
                     "data_norm": NORM, "lr": 1e-4, "adam": True}}
    return case, jax_side


def _nll_step_case():
    spec = srflow_specs(tiny=True)[0]
    jm = jregistry.make(spec)
    jm.params = live_flow(jm.params)
    rng = np.random.default_rng(2)
    batch = {"GT": rng.random((8, 16, 16, 3)).astype(np.float32),
             "LQ": rng.random((8, 4, 4, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(0)

    def jax_side():
        step = j_nll_step(jm, grad_capture(), 1.0, 0.0, rrdb_unfreeze_step=0)
        _, grads, mets = step(jm.params, grad_capture().init(jm.params),
                              _jb(batch), key, jnp.asarray(0))
        return ({k: float(v) for k, v in mets.items()},
                {k: v.numpy() for k, v in
                 srflow_state_dict(_np_tree(grads), jm.plan).items()})

    tm = registry.make(spec)
    tm.load_state_dict(srflow_state_dict(_np_tree(jm.params), tm.plan))
    case = {"step": "srflow_nll", "recipe": {"srflow": state_of(tm)},
            "batch": batch, "mesh": {"dp": 2},
            "opts": {"freeze_rrdb": False, "rrdb_unfreeze_step": 0,
                     "noise": jax_noise(key, batch["GT"].shape),
                     "lr": 1e-4, "adam": True}}
    return case, jax_side


def _prior_step_case():
    jm, jp, tm, _ = tiny_pair()
    batch = prior_batch(seed=3, n=4, gt_size=64)

    def jax_side():
        step = j_prior_step(jm, jp, grad_capture(), 1.0, 1.0)
        _, grads, mets = step(jp.params, grad_capture().init(jp.params),
                              jm.params, _jb(batch))
        return ({k: float(v) for k, v in mets.items()},
                {k: v.numpy() for k, v in
                 srflow_unet_state_dict(_np_tree(grads)).items()})

    case = {"step": "srflow_prior",
            "recipe": {"srflow": state_of(tm),
                       "prior": state_of(port_prior())},
            "batch": batch, "mesh": {"dp": 2},
            "opts": {"eps_weight": 1.0, "image_weight": 1.0, "lr": 1e-3,
                     "adam": True}}
    return case, jax_side


def _linf_predict_cases():
    """(sp case, dp case, a function that returns (the JAX image of the sp
    input, the JAX images of the dp batch))."""
    jm, jprior, tm, tprior = linf_predict_models()
    rng = np.random.default_rng(4)
    recipe = {"linf": state_of(tm), "prior": state_of(tprior), "vgg": None}
    h, w, s = 6, 8, 2
    H, W = h * s, w * s

    def inputs(b):
        return {"inp": rng.random((b, h, w, 3)).astype(np.float32),
                "coord": np.broadcast_to(make_coord_np((H, W), flatten=False)
                                         [None], (b, H, W, 2)).copy(),
                "cell": np.broadcast_to(make_cell((H, W))[None],
                                        (b, 2)).copy(),
                "gt_lr_up": (rng.random((b, H, W, 3)) - 0.5).astype(
                    np.float32),
                "gt": rng.random((b, H, W, 3)).astype(np.float32)}

    one, four = inputs(1), inputs(4)
    one.pop("gt")
    jpred = JLINFPredictor(jm, jprior, tile_queries=H * W, use_pallas=False)

    def jax_predict(d):
        return np.asarray(jpred.predict(
            jm.params, jprior.params, *(jnp.asarray(d[k]) for k in
                                        ("inp", "coord", "cell",
                                         "gt_lr_up"))))

    return ({"predict": "linf_sp", "recipe": recipe, "inputs": one,
             "mesh": {"sp": 2}},
            {"predict": "linf_dp", "recipe": recipe, "inputs": four,
             "mesh": {"dp": 2}},
            lambda: (jax_predict(one), jax_predict(four)))


def _srflow_predict_case():
    jm, jp, tm, tp = tiny_pair()
    lr = np.random.default_rng(5).random((2, 8, 8, 3)).astype(np.float32)
    return ({"predict": "srflow_dp",
             "recipe": {"srflow": state_of(tm), "prior": state_of(tp)},
             "inputs": {"lr": lr}, "mesh": {"dp": 2}},
            lambda: np.stack([JPredictor(jm, jp).predict(x) for x in lr]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks (one spawn at world 2 for five cases, one at
    world 4) and its JAX side, computed here while the ranks run."""
    linf_step, j_linf = _linf_step_case()
    (nll, j_nll), (prior, j_prior) = _nll_step_case(), _prior_step_case()
    sp, dp, j_linf_predicts = _linf_predict_cases()
    sr, j_sr = _srflow_predict_case()
    two = [nll, prior, sp, dp, sr]
    # the two worlds at once (six ranks of one thread each)
    with ThreadPoolExecutor(2) as pool:
        four = pool.submit(spawn, run_cases, 4, "gloo",
                           args=([linf_step], "cpu"),
                           store_dir=tmp_path_factory.mktemp("w4"), **SPAWN)
        ranks2 = pool.submit(spawn, run_cases, 2, "gloo", args=(two, "cpu"),
                             store_dir=tmp_path_factory.mktemp("w2"), **SPAWN)
        refs = {"linf": j_linf(), "nll": j_nll(), "prior": j_prior()}
        j_sp, j_dp = j_linf_predicts()
        j_sr = j_sr()
        ranks2, ranks4 = ranks2.result(), four.result()
    by = {name: [r[i] for r in ranks2]
          for i, name in enumerate(("nll", "prior", "sp", "dp", "sr"))}
    by["linf"] = [r[0] for r in ranks4]
    return {"linf": (linf_step, *refs["linf"]),
            "nll": (nll, *refs["nll"]), "prior": (prior, *refs["prior"]),
            "sp": (sp, j_sp), "dp": (dp, j_dp), "sr": (sr, j_sr)}, by


@pytest.mark.parametrize("name", ["linf", "nll", "prior"])
def test_sharded_step_matches_single_and_jax(runs, name):
    """The LINF-LP dp x sp step (world 4), the SRFlow NLL dp step and the
    SRFlow-LP prior dp step (world 2), each against the port's step on one
    process and against the JAX step; every rank takes the same step."""
    cases, by = runs
    case, jmets, jgrads = cases[name]
    ranks = by[name]
    print(check_against_single(case, ranks, f"{name} sharded step", "cpu"))
    _hold_vs_jax(name, ranks[0], jmets, jgrads)
    want = {"linf": {"conv3x3_cat", "linf_info", "linf_flow_forward",
                     "linf_flow_inverse"}}.get(name)
    # the CPU runs the kernels' twins: no launch is counted
    assert not ranks[0]["launches"], (name, ranks[0]["launches"], want)


def test_query_sharded_predict_matches_single_and_jax(runs):
    """Each rank's rows of the HR grid (with the prior: z gathered before
    the UNet) are the single predict's rows and the JAX predictor's."""
    cases, by = runs
    case, ref = cases["sp"]
    single = run_cases([dict(case, mesh=None)], "cpu")[0]["out"]
    parts = [r["out"] for r in by["sp"]]
    assert [p.shape for p in parts] == [(1, 6, 16, 3)] * 2
    got = np.concatenate(parts, axis=1)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def test_dp_predict_keeps_its_images_and_psnr(runs):
    """Each rank holds exactly B / dp images, those of the single predicts
    and of the JAX predictor on the batch; the dp PSNR over both ranks is
    the PSNR of the whole batch."""
    cases, by = runs
    case, ref = cases["dp"]
    single = run_cases([dict(case, mesh=None)], "cpu")[0]["out"]
    parts = [r["out"] for r in by["dp"]]
    assert [p.shape[0] for p in parts] == [2, 2]
    got = np.concatenate(parts)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    gt = case["inputs"]["gt"]
    mse = np.mean((np.clip(single, 0, 1).astype(np.float64) - gt) ** 2)
    for r in by["dp"]:
        np.testing.assert_allclose(r["psnr"], -10 * np.log10(mse), rtol=1e-5)


def test_srflow_dp_predict_one_lr_a_rank(runs):
    cases, by = runs
    case, ref = cases["sr"]
    single = run_cases([dict(case, mesh=None)], "cpu")[0]["out"]
    parts = [r["out"] for r in by["sr"]]
    assert [p.shape for p in parts] == [(1, 32, 32, 3)] * 2
    got = np.concatenate(parts)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


def test_dryrun_multichip_2(tmp_path):
    """The three sharded steps at n = 2 against one process each, then the
    spatial SRFlow predict (one LR of 16 x 16 over sp 2) against one
    process."""
    lines = dryrun_multichip(2, store_dir=tmp_path)
    assert len(lines) == 4 and "dp2xsp1" in lines[0]
    assert all("2 ranks agree" in line for line in lines[:3])
    assert "spatial SRFlow predict" in lines[3] and "sp2" in lines[3]
    assert "of one process (tol 1e-05)" in lines[3]


def test_multiproc_dryrun(tmp_path):
    """Two processes each feed their loader shard into one dp step: the
    global loss and the parameters after Adam are one process's on the
    same global batch."""
    line = multiproc_dryrun.run(store_dir=tmp_path)
    assert "2 ranks agree" in line
