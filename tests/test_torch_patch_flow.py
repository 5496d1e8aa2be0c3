"""Port parity: the K4 twin (the generic-d pointwise flow over
channel-major info) against the JAX pointwise flow and its generic-d
Pallas kernels (interpret mode on CPU), with the recipe of
tests/test_pallas_flow.py's d = 27 case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfsr_tpu.ops import pointwise_flow as jpwf
from bfsr_tpu.ops.pallas import linf_flow as jlf
from bfsr_tpu_torch.ops import pointwise_flow as tpwf
from bfsr_tpu_torch.ops.cuda import linf_flow as tlf


def _flow(rng, d, n_layers, n):
    """JAX and port flow params (w * 0.05 + I: random d x d layers are
    ill-conditioned), an input and its row-major (n, 2dL) info."""
    params = jpwf.init_pointwise_flow(jax.random.PRNGKey(0), n_layers,
                                      patch_size=int(round((d / 3) ** 0.5)))
    w = np.asarray(params["w"]) * 0.05 + np.eye(d, dtype=np.float32)[None]
    b = (0.1 * rng.standard_normal((n_layers + 1, d))).astype(np.float32)
    jp = jpwf.cache_inverses({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tp = tpwf.cache_inverses({"w": torch.from_numpy(w),
                              "b": torch.from_numpy(b)})
    x = rng.random((n, d)).astype(np.float32)
    info = (rng.random((n, 2 * d * n_layers)) - 0.5).astype(np.float32)
    return jp, tp, x, info


def test_k4_twin_matches_pallas_and_jnp_at_d27(rng):
    jp, tp, x, info = _flow(rng, 27, 4, 300)
    info_cm = torch.from_numpy(info.T.copy())
    z = tlf.flow_forward_plain(tp["w"], tp["b"], torch.from_numpy(x), info_cm)
    z_jnp, _ = jpwf.forward(jp, jnp.asarray(x), jnp.asarray(info))
    z_pal = jlf.flow_forward(jp, jnp.asarray(x), jnp.asarray(info),
                             interpret=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jnp), atol=2e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_pal), atol=2e-5)

    z_np = np.array(z_jnp)
    zj = jnp.asarray(z_np)
    xr = tlf.flow_inverse_plain(tp["w_inv"], tp["b"], torch.from_numpy(z_np),
                                info_cm)
    x_jnp = jpwf.inverse(jp, zj, jnp.asarray(info))
    x_pal = jlf.flow_inverse(jp, zj, jnp.asarray(info), interpret=True)
    np.testing.assert_allclose(xr.numpy(), np.asarray(x_jnp), atol=2e-4)
    np.testing.assert_allclose(xr.numpy(), np.asarray(x_pal), atol=2e-4)
    np.testing.assert_allclose(xr.numpy(), x, atol=2e-4)


@pytest.mark.parametrize("d,n_layers,n", [(12, 3, 257), (48, 2, 129),
                                          (27, 10, 64)])
def test_k4_twin_matches_jnp_and_round_trips(rng, d, n_layers, n):
    jp, tp, x, info = _flow(rng, d, n_layers, n)
    info_cm = torch.from_numpy(info.T.copy())
    z = tlf.flow_forward_plain(tp["w"], tp["b"], torch.from_numpy(x), info_cm)
    z_jnp, _ = jpwf.forward(jp, jnp.asarray(x), jnp.asarray(info))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jnp), atol=2e-5)
    xr = tlf.flow_inverse_plain(tp["w_inv"], tp["b"], z, info_cm)
    np.testing.assert_allclose(
        xr.numpy(), np.asarray(jpwf.inverse(jp, jnp.asarray(z.numpy()),
                                            jnp.asarray(info))), atol=2e-4)
    np.testing.assert_allclose(xr.numpy(), x, atol=2e-4)
    # the port's row-major flow (query_log_p's) is the same map
    z_rm, _ = tpwf.forward(tp, torch.from_numpy(x), torch.from_numpy(info))
    torch.testing.assert_close(z, z_rm, rtol=0, atol=2e-5)


def test_wrapper_runs_the_twin_on_cpu_at_any_d(rng):
    """d = 3 goes to K1's twin and d = 27 to K4's; the twin is the same
    function at every d, and a mis-shaped info raises."""
    for d in (3, 27):
        _, tp, x, info = _flow(rng, d, 3, 100)
        xt, info_cm = torch.from_numpy(x), torch.from_numpy(info.T.copy())
        for wrap, plain, w in ((tlf.flow_forward, tlf.flow_forward_plain,
                                tp["w"]),
                               (tlf.flow_inverse, tlf.flow_inverse_plain,
                                tp["w_inv"])):
            torch.testing.assert_close(wrap(w, tp["b"], xt, info_cm),
                                       plain(w, tp["b"], xt, info_cm),
                                       rtol=0, atol=0)
        with pytest.raises(ValueError):
            tlf.flow_forward(tp["w"], tp["b"], xt, info_cm[:-1])
        with pytest.raises(ValueError):
            tlf.flow_forward(tp["w"], tp["b"][:, :-1], xt, info_cm)


def test_d3_twin_reads_k1_rows(rng):
    """At d = 3 the generic twin reads layer i's s and t from info rows
    6i..6i+2 and 6i+3..6i+5, K1's layout."""
    jp, tp, x, info = _flow(rng, 3, 3, 50)
    info_cm = torch.from_numpy(info.T.copy())
    z = tlf.flow_forward_plain(tp["w"], tp["b"], torch.from_numpy(x), info_cm)
    z_pal = jlf.flow_forward(jp, jnp.asarray(x), jnp.asarray(info),
                             interpret=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_pal), atol=1e-5)
