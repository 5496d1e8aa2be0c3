"""The port's parallel layer on the CPU, over gloo: the mesh's layout and
``shard_batch``'s refusals, ``distributed_mean`` / ``distributed_psnr``
against the JAX ones (``tests/test_collective.py``), the global BatchNorm
of a data-parallel step against one process on the whole batch (the
output, the statistics and running stats, the gradients), the global
batch's random draws, the spawn helper's failure and timeout, and the
sharded loader against the JAX ``GrainLoader``'s shard lengths.

Every multi-process case runs through ``parallel.mesh.spawn`` with its
``file://`` store under ``tmp_path``, an init timeout and a join timeout,
so a hang fails in seconds; one spawn runs several cases
(``parallel.checks.run``).

Tolerances: the collectives within 1e-6 (the mean) and 1e-5 (the PSNR)
relative, as ``tests/test_collective.py`` holds the JAX ones; the global
BatchNorm's output, statistics and gradients within 1e-5 (float32
reduction order: two-pass sums over ranks against one process's mean).
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

from bfsr_tpu_torch.data.sharded_loader import ShardedLoader
from bfsr_tpu_torch.parallel import checks
from bfsr_tpu_torch.parallel.mesh import (Mesh, batch_specs_linf,
                                          batch_specs_srflow, mesh_sizes,
                                          shard_batch, spawn)

SPAWN = {"init_timeout": 60.0, "join_timeout": 180.0, "threads": 1}


def _inputs():
    rng = np.random.default_rng(0)
    return {"values": rng.random(64).astype(np.float32),
            "se": rng.random(32).astype(np.float32),
            "n": np.full(32, 100.0, np.float32),
            "x": (rng.standard_normal((4, 5, 6, 8)) * 2 + 1).astype(
                np.float32)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results of the collectives, the global BatchNorm and
    the global draw, one spawn."""
    d = _inputs()
    calls = [("collectives", (d["values"], d["se"], d["n"])),
             ("batch_norm_case", (d["x"], 3)),
             ("dp_draws", (5, 4)),
             ("replicate_case", ())]
    return d, spawn(checks.run, 2, "gloo", args=(calls,),
                    store_dir=tmp_path_factory.mktemp("store"), **SPAWN)


def test_collectives_match_jax(world2):
    """``distributed_mean`` / ``distributed_psnr`` over a dp group of 2
    give the JAX collectives' values (an 8-device mesh), on every rank."""
    import jax

    from bfsr_tpu.parallel.collective import (distributed_mean as j_mean,
                                              distributed_psnr as j_psnr)
    from bfsr_tpu.parallel.mesh import make_mesh as j_make_mesh

    d, ranks = world2
    if len(jax.devices()) < 8:
        pytest.skip("the JAX collectives need 8 virtual devices")
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = j_make_mesh({"dp": 8})

    def sh(a):
        return jax.device_put(a, NamedSharding(mesh, P("dp")))

    ref_mean = float(j_mean(mesh, sh(d["values"])))
    ref_psnr = float(j_psnr(mesh, sh(d["se"]), sh(d["n"])))
    for r in ranks:
        got = r[0]
        np.testing.assert_allclose(got["mean"], ref_mean, rtol=1e-6)
        np.testing.assert_allclose(got["mean"], d["values"].mean(), rtol=1e-6)
        np.testing.assert_allclose(got["psnr"], ref_psnr, rtol=1e-5)
        np.testing.assert_allclose(
            got["psnr"], -10 * np.log10(d["se"].sum() / d["n"].sum()),
            rtol=1e-5)


def test_global_batch_norm_matches_one_process(world2):
    """BatchNorm inside ``fnn.data_parallel`` over 2 ranks, each on half
    the batch, gives one process's BatchNorm over the whole batch: the
    output rows, the mean and unbiased variance, the running stats, the
    input's gradient rows, and the affine's gradients summed over the
    ranks (each rank's is its share of the global loss's)."""
    d, ranks = world2
    ref = checks.batch_norm_single(d["x"], 3)
    bns = [r[1] for r in ranks]
    tol = {"rtol": 1e-5, "atol": 1e-5}
    np.testing.assert_allclose(np.concatenate([b["y"] for b in bns]),
                               ref["y"], **tol)
    np.testing.assert_allclose(np.concatenate([b["gx"] for b in bns]),
                               ref["gx"], **tol)
    for k in ("gweight", "gbias"):
        np.testing.assert_allclose(sum(b[k] for b in bns), ref[k], **tol)
    for b in bns:
        for k in ("mean", "var", "running_mean", "running_var"):
            np.testing.assert_allclose(b[k], ref[k], err_msg=k, **tol)
    # the global statistics, not each half's
    half = checks.batch_norm_single(d["x"][:2], 3)
    assert np.abs(half["mean"] - ref["mean"]).max() > 1e-2


def test_global_rows_draws_for_the_global_batch(world2):
    """A per-sample draw inside a dp scope (stochastic depth, the SRFlow
    NLL's quantisation noise) is the global batch's draw, each rank its
    rows."""
    _, ranks = world2
    ref = checks.global_draw(5, 8)
    np.testing.assert_array_equal(np.concatenate([r[2] for r in ranks]), ref)


def test_replicate_broadcasts_rank_0s_module_and_optimizer(world2):
    """After ``replicate`` every rank holds rank 0's parameters, buffers
    (BatchNorm's running stats and count) and Adam state (moments and
    step), where each rank's differed before."""
    _, ranks = world2
    got = [r[3] for r in ranks]
    for k in ("params", "buffers", "state"):
        for a, b in zip(got[0][k], got[1][k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    from bfsr_tpu_torch.parallel.checks import batch_norm_module

    own = [p.detach().numpy() for p in batch_norm_module(4, 1)[0]
           .parameters()]
    assert not np.array_equal(own[0], got[1]["params"][0])


def test_mesh_layout_at_world_4(tmp_path):
    """{'dp': 2, 'sp': -1} over 4 ranks: row-major, rank = 2 i_dp + i_sp,
    the dp group the ranks of one sp index and the sp group those of one
    dp index, in their index order."""
    out = spawn(checks.run, 4, "gloo",
                args=([("mesh_layout", ({"dp": 2, "sp": -1},))],),
                store_dir=tmp_path, **SPAWN)
    for r, (lay,) in enumerate(out):
        i_dp, i_sp = divmod(r, 2)
        assert lay["rank"] == r
        assert lay["coords"] == {"dp": i_dp, "sp": i_sp}
        assert lay["members"]["dp"] == [i_sp, 2 + i_sp]
        assert lay["members"]["sp"] == [2 * i_dp, 2 * i_dp + 1]


def test_mesh_sizes_and_shard_batch_refuse():
    assert mesh_sizes({"dp": -1, "sp": 2}, 8) == (["dp", "sp"], [4, 2])
    for axes, world in (({"dp": 3}, 4), ({"dp": -1, "sp": 3}, 4),
                        ({"dp": -1, "sp": -1}, 4)):
        with pytest.raises(ValueError):
            mesh_sizes(axes, world)
    mesh = Mesh(("dp", "sp"), (2, 2), 3, {})
    batch = {"inp": np.zeros((4, 6, 6, 3)), "coord": np.zeros((4, 12, 12, 2)),
             "cell": np.zeros((4, 2))}
    got = shard_batch(batch, mesh, batch_specs_linf("sp"))
    assert got["inp"].shape == (2, 6, 6, 3)
    assert got["coord"].shape == (2, 6, 12, 2)
    with pytest.raises(ValueError, match="divide"):
        shard_batch({"GT": np.zeros((3, 8, 8, 3))}, mesh,
                    batch_specs_srflow())
    with pytest.raises(ValueError, match="divide"):
        shard_batch({"coord": np.zeros((4, 5, 8, 2))}, mesh,
                    batch_specs_linf("sp"))


def test_spawn_fails_fast_on_a_failed_rank_and_a_hang(tmp_path):
    """A rank that raises while the others wait in a barrier stops every
    rank and raises here with its traceback; a rank left waiting in a
    collective fails at the join's timeout, not the suite's."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn(checks.run, 2, "gloo", args=([("fault", ("raise",))],),
              store_dir=tmp_path, **SPAWN)
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn(checks.run, 2, "gloo", args=([("fault", ("hang",))],),
              store_dir=tmp_path, init_timeout=60.0, join_timeout=8.0,
              threads=1)
    assert time.monotonic() - t0 < 50


class _DS:
    def __init__(self, n=12):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 2), i, np.float32), "idx": np.int64(i)}


def _indices(loader):
    return [int(v) for b in loader for v in np.ravel(b["idx"])]


@pytest.mark.parametrize("n,count,bs,drop", [
    (13, 3, 2, False), (13, 3, 2, True), (12, 3, 2, False),
    (14, 4, 3, False), (12, 2, 2, False)])
def test_sharded_loader_matches_grain_lengths(n, count, bs, drop):
    """Each shard's ``len`` is the JAX ``GrainLoader``'s for the same (n,
    count, bs, drop_last) and the batches it yields; the shards are
    disjoint, each n // count records, and together the dataset when
    count divides n."""
    from bfsr_tpu.data.grain_loader import GrainLoader

    shards = []
    for i in range(count):
        ld = ShardedLoader(_DS(n), batch_size=bs, shuffle=True, seed=3,
                           drop_last=drop, shard_index=i, shard_count=count,
                           num_workers=1)
        ref = GrainLoader(_DS(n), batch_size=bs, shuffle=True, seed=3,
                          drop_last=drop, shard_index=i, shard_count=count)
        assert len(ld) == len(ref) == sum(1 for _ in ld), (i, count)
        shards.append(ld.shard_indices(0))
    flat = np.concatenate(shards)
    assert len(set(flat.tolist())) == len(flat) == count * (n // count)
    if n % count == 0:
        assert sorted(flat.tolist()) == list(range(n))


def test_sharded_loader_epochs_and_defaults():
    """Each ``iter()`` is an epoch reshuffled from seed + epoch, the same
    on every shard; without a process group the loader is one shard of
    the whole dataset."""
    a = ShardedLoader(_DS(), batch_size=3, shuffle=True, seed=7,
                      shard_index=0, shard_count=1, num_workers=2)
    e0, e1 = _indices(a), _indices(a)
    assert sorted(e0) == sorted(e1) == list(range(12)) and e0 != e1
    b = ShardedLoader(_DS(), batch_size=3, shuffle=True, seed=7,
                      num_workers=1)
    assert b.shard == (0, 1) and _indices(b) == e0
    halves = [ShardedLoader(_DS(), batch_size=2, shuffle=True, seed=7,
                            shard_index=i, shard_count=2).shard_indices(1)
              for i in range(2)]
    assert np.concatenate(halves).tolist() == e1
    batch = next(iter(b))
    assert batch["x"].shape == (3, 2, 2)
    with pytest.raises(ValueError):
        ShardedLoader(_DS(), shard_index=2, shard_count=2)
    assert torch.is_tensor(torch.as_tensor(batch["x"]))
