"""Port parity: the whole SRFlow-LP learned-prior inference slice against
the JAX ``SRFlowLPPredictor``, the SRFlow entry points, and the port's
import hygiene (no jax, no bfsr_tpu).

Tolerances (``docs/PARITY.md``): 2e-3 for the encoded epses, 5e-3 for the
SR image; 5e-5 for the per-pixel standardisation (a module).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.models.srflow.srflow_net import standardize_epses as j_std
from bfsr_tpu.ops.interp import resize_bilinear as j_resize
from bfsr_tpu.pipelines.srflow_eval import SRFlowLPPredictor as JPredictor
from bfsr_tpu_torch.entry import build_srflow_lp
from bfsr_tpu_torch.models.srflow.srflow_net import standardize_epses
from bfsr_tpu_torch.ops.interp import resize_bilinear
from bfsr_tpu_torch.pipelines.srflow_eval import SRFlowLPPredictor

from test_torch_srflow_models import tiny_pair


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)])
def test_predict_matches_jax(rng, h, w):
    jm, jp, tm, tp = tiny_pair()
    lr = rng.random((h, w, 3)).astype(np.float32)
    ref = JPredictor(jm, jp).predict(lr)
    got = {}
    for kernels in (True, False):
        got[kernels] = SRFlowLPPredictor(tm, tp, kernels=kernels).predict(
            torch.from_numpy(lr))
        assert got[kernels].shape == (4 * h, 4 * w, 3)
        np.testing.assert_allclose(got[kernels].numpy(), ref, atol=5e-3)
    # a numpy image goes to the model's device, the same result
    np.testing.assert_array_equal(SRFlowLPPredictor(tm, tp).predict(lr)
                                  .numpy(), got[True].numpy())


@pytest.mark.parametrize("kernels", [True, False])
def test_epses_match_jax(rng, kernels):
    jm, _, tm, _ = tiny_pair()
    lr = rng.random((1, 6, 10, 3)).astype(np.float32)
    jlr = jnp.asarray(lr)
    enc = jm.preprocess(jm.params, jlr)
    ref, _, _ = jm.normal_flow(jm.params, j_resize(jlr, (24, 40)), jlr,
                               add_gt_noise=False, lr_enc=enc,
                               want_logdet=False)
    t = torch.from_numpy(lr)
    with torch.no_grad():
        cache = tm.precompute_ft(tm.rrdb_preprocess(t, kernels=kernels))
        got = tm.normal_flow(resize_bilinear(t, (24, 40)), cache, kernels)
        assert [tuple(e.shape) for e in got] == [(1, 12, 20, 6), (1, 3, 5, 96)]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3,
                                       rtol=2e-3)
        # decode inverts encode
        back = tm.reverse_flow(got, cache, kernels)
    np.testing.assert_allclose(back.numpy(), resize_bilinear(t, (24, 40))
                               .numpy(), atol=2e-3)


def test_standardize_epses_matches_jax(rng):
    es = [rng.standard_normal((1, 4, 6, c)).astype(np.float32) for c in (6, 96)]
    ref = j_std([jnp.asarray(e) for e in es])
    for g, r in zip(standardize_epses([torch.from_numpy(e) for e in es]), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5,
                                   rtol=5e-5)


def test_build_srflow_lp_runs_tiny_on_cpu():
    m, p = build_srflow_lp("cpu", tiny=True)
    lr = torch.rand((16, 15, 3), generator=torch.Generator().manual_seed(0))
    out = SRFlowLPPredictor(m, p).predict(lr)
    assert out.shape == (64, 60, 3) and torch.isfinite(out).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    a, _ = build_srflow_lp("cpu", seed=1, tiny=True)
    b, _ = build_srflow_lp("cpu", seed=2, tiny=True)
    assert not torch.equal(a.RRDB.conv_first.weight, b.RRDB.conv_first.weight)
    z = a.sample_z(0.0, (6, 10))
    assert z.shape == (1, 3, 5, 96) and not z.any()
    with pytest.raises(ValueError):       # tiny: K3 / K5 do not take it
        build_srflow_lp("cuda", tiny=True)
    with pytest.raises(ValueError):       # unfrozen
        from bfsr_tpu_torch import registry
        from bfsr_tpu_torch.entry import srflow_specs

        specs = srflow_specs(tiny=True)
        SRFlowLPPredictor(registry.make(specs[0]), registry.make(specs[1]))


def test_live_random_flow_is_live_and_stable():
    """The seeded flagship-style init keeps the coupling live (scales not
    a constant) and the inverse finite; tiny widths, CPU."""
    m, p = build_srflow_lp("cpu", seed=0, tiny=True)
    lr = torch.from_numpy(np.random.default_rng(0).random((1, 8, 8, 3))
                          .astype(np.float32))
    with torch.no_grad():
        cache = m.precompute_ft(m.rrdb_preprocess(lr))
        c = m.plan[3]["c"]
        scale_ft = cache[3][..., :c]
        assert float(scale_ft.std()) > 1e-3
        assert 0.5 < float(scale_ft.min()) and float(scale_ft.max()) < 1.0001
        sr = SRFlowLPPredictor(m, p).run(lr)
    assert torch.isfinite(sr).all()


def test_port_imports_no_jax_with_jax_blocked():
    """Every module of bfsr_tpu_torch and chip_smoke.py import with jax and
    bfsr_tpu made unimportable."""
    code = (
        "import pkgutil, sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'bfsr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import bfsr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    bfsr_tpu_torch.__path__, 'bfsr_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'bfsr_tpu_torch.pipelines.srflow_eval' in names\n"
        "assert 'bfsr_tpu_torch.ops.cuda.flow_step' in names\n"
        "for m in ('pipelines.srflow_prior_train', 'cli.srflow_train',\n"
        "          'data.pkl_dataset', 'cli.test', 'cli.srflow_test',\n"
        "          'models.lpips', 'utils.measure', 'convert.load',\n"
        "          'pipelines.srflow_train', 'pipelines.sr_train',\n"
        "          'pipelines.losses', 'models.rrdb', 'train.optim',\n"
        "          'profiling.base_train_probe', 'models.swinir',\n"
        "          'models.swin_latent', 'models.edsr_latent', 'models.rdn',\n"
        "          'models.mlp', 'data.image_folder'):\n"
        "    assert 'bfsr_tpu_torch.' + m in names, m\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.startswith('jax') or m.startswith('bfsr_tpu.'))]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
