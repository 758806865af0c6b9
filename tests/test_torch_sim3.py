"""Sim3, Umeyama / Sim3 RANSAC and pose-graph optimization: the port against
the JAX package.

Tolerances: Sim3 exp / log / inverse / adjoint in float64 within 1e-12,
including angles and sigma below the branch cut-offs (1e-5); Umeyama with
and without scale, on a general and a planar set, within 1e-10 (float64);
``sim3_ransac`` with 30% outliers in float32 on the same key, with no
hook: the port draws the JAX function's sample indices (float64 draws, as
JAX's under the tests' x64), picks the same best hypothesis (1e-4) and
polishes it to s, R, t within 1e-4 with the same inlier set; ``solve_pgo`` SE3 and Sim3 on
tests/test_pgo_bow.py's ring graphs in float64: poses within 1e-8, and
reruns bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pgo_bow import _ring_graph

from snakeslam_tpu.core import lie as JL
from snakeslam_tpu.ops import pgo as JP
from snakeslam_tpu.ops import sim3_solver as JS
from snakeslam_tpu_torch.core import lie as TL
from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.ops import pgo as TP
from snakeslam_tpu_torch.ops import sim3_solver as TS
from snakeslam_tpu_torch.ops.linalg import svd3x3


def _tangents(rng):
    """Sim3 tangents (v, w, sigma): general, and with the angle, sigma or
    both below the 1e-5 cut-offs of _sim3_W_coeffs (and exactly zero)."""
    xi = rng.normal(size=(12, 7)) * np.array([0.5] * 3 + [0.4] * 3 + [0.2])
    xi[2:4, 3:6] *= 1e-7          # angle below the cut-off
    xi[4:6, 6] *= 1e-7            # sigma below the cut-off
    xi[6:8, 3:] *= 1e-7           # both
    xi[8, 3:6] = 0.0              # exactly zero angle
    xi[9, 6] = 0.0                # exactly zero sigma
    xi[10, 3:] = 0.0              # both zero
    xi[11, 3:6] *= 3e-5           # angle just above the cut-off
    return xi


def test_sim3_exp_log_inverse_adjoint(rng):
    xi = _tangents(rng)
    Sj = np.asarray(JL.sim3_exp(jnp.asarray(xi)))
    St = TL.sim3_exp(torch.as_tensor(xi))
    np.testing.assert_allclose(St.numpy(), Sj, atol=1e-12)
    np.testing.assert_allclose(TL.sim3_log(St).numpy(),
                               np.asarray(JL.sim3_log(jnp.asarray(Sj))),
                               atol=1e-12)
    np.testing.assert_allclose(TL.sim3_log(St).numpy(), xi, atol=1e-12)
    np.testing.assert_allclose(TL.sim3_inverse(St).numpy(),
                               np.asarray(JL.sim3_inverse(jnp.asarray(Sj))),
                               atol=1e-12)
    np.testing.assert_allclose(TL.sim3_scale(St).numpy(), np.exp(xi[:, 6]),
                               atol=1e-12)
    np.testing.assert_allclose(TL.sim3_to_se3(St).numpy(),
                               np.asarray(JL.sim3_to_se3(jnp.asarray(Sj))),
                               atol=1e-12)
    np.testing.assert_allclose(TP.sim3_adjoint(St).numpy(),
                               np.asarray(JP.sim3_adjoint(jnp.asarray(Sj))),
                               atol=1e-12)
    T = JL.se3_exp(jnp.asarray(xi[:, :6]))
    np.testing.assert_allclose(
        TP._se3_adjoint(torch.as_tensor(np.array(T))).numpy(),
        np.asarray(JP._se3_adjoint(T)), atol=1e-12)


def test_svd3x3_reconstructs(rng):
    A = rng.normal(size=(64, 3, 3))
    A[:8, :, 2] = A[:8, :, 0] * 0.5 + A[:8, :, 1]    # rank 2
    A[8:12] = 0.0                                      # zero
    U, sig, Vt = svd3x3(torch.as_tensor(A))
    U, sig, Vt = U.numpy(), sig.numpy(), Vt.numpy()
    np.testing.assert_allclose((U * sig[:, None, :]) @ Vt, A, atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(U)[12:], 1.0, atol=1e-12)
    ref = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(np.abs(sig), ref, atol=1e-12)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_matches_jax(rng, planar, with_scale):
    src = rng.normal(size=(60, 3)) * 2.0
    if planar:
        src[:, 2] = 0.0
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(size=3))))
    dst = 1.3 * src @ R.T + np.array([1.0, -2.0, 0.5])
    dst += rng.normal(size=dst.shape) * 1e-3
    w = rng.uniform(0.2, 1.0, size=60)
    sj, Rj, tj = JS.umeyama_jax(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w), with_scale=with_scale)
    st, Rt, tt = TS.umeyama(torch.as_tensor(src), torch.as_tensor(dst),
                            torch.as_tensor(w), with_scale=with_scale)
    assert abs(float(st) - float(sj)) < 1e-10
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-10)
    np.testing.assert_allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-10)


@pytest.mark.parametrize("with_scale", [True, False])
def test_sim3_ransac_with_outliers(rng, with_scale):
    N = 200
    src = rng.uniform(-3.0, 3.0, size=(N, 3)) + np.array([0.0, 0.0, 6.0])
    R = np.asarray(JL.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
    s = 1.1 if with_scale else 1.0
    dst = s * src @ R.T + np.array([0.3, -0.1, 0.2])
    dst += rng.normal(size=dst.shape) * 0.005
    out = rng.choice(N, int(0.3 * N), replace=False)
    dst[out] += rng.uniform(0.5, 2.0, size=(len(out), 3)) * rng.choice(
        [-1.0, 1.0], size=(len(out), 3))
    src32, dst32 = src.astype(np.float32), dst.astype(np.float32)
    mask = np.ones(N, dtype=bool)
    mask[-5:] = False                    # masked pairs are never inliers
    key = jax.random.PRNGKey(7)
    sj, Rj, tj, inl_j, nj = JS.sim3_ransac(
        jnp.asarray(src32), jnp.asarray(dst32), jnp.asarray(mask), key,
        threshold=0.05, with_scale=with_scale)
    with prng.x64(True):
        idx = prng.sample_without_replacement(
            np.asarray(key), torch.as_tensor(mask), 128, 3)
    st, Rt, tt, inl_t, nt = TS.sim3_ransac(
        torch.as_tensor(src32), torch.as_tensor(dst32), torch.as_tensor(mask),
        idx, threshold=0.05, with_scale=with_scale)
    # the JAX function's draw (ops/sim3_solver.py:58-63)
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key, (128, N), minval=1e-9,
                                                  maxval=1.0)))
    jidx = np.asarray(jax.lax.top_k(
        jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)[None] + gumbel, 3)[1])
    np.testing.assert_array_equal(idx.numpy(), jidx)
    # the same best hypothesis, as scored by each package
    ones = torch.ones((128, 3))
    sh, Rh, th = TS.umeyama(torch.as_tensor(src32)[idx],
                            torch.as_tensor(dst32)[idx], ones,
                            with_scale=with_scale)
    err = torch.linalg.norm(
        sh[:, None, None] * torch.einsum("hij,nj->hni", Rh,
                                         torch.as_tensor(src32))
        + th[:, None] - torch.as_tensor(dst32)[None], dim=-1)
    best_t = int(torch.argmax(((err < 0.05) & torch.as_tensor(mask)).sum(1)))
    sjh, Rjh, tjh = jax.vmap(lambda i: JS.umeyama_jax(
        jnp.asarray(src32)[i], jnp.asarray(dst32)[i], jnp.ones(3, jnp.float32),
        with_scale=with_scale))(jidx)
    errj = jnp.linalg.norm(
        sjh[:, None, None] * jnp.einsum("hij,nj->hni", Rjh, src32)
        + tjh[:, None] - dst32[None], axis=-1)
    best_j = int(jnp.argmax(((errj < 0.05) & jnp.asarray(mask)).sum(1)))
    assert best_t == best_j
    np.testing.assert_allclose(Rh[best_t].numpy(), np.asarray(Rjh[best_j]),
                               atol=1e-4)
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj) >= 0.6 * N
    assert not inl_t.numpy()[out].any() and not inl_t.numpy()[-5:].any()
    assert abs(float(st) - float(sj)) < 1e-4
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


def _graph_to_torch(g):
    return TP.PoseGraph(*(torch.as_tensor(np.array(x)) for x in g))


@pytest.mark.parametrize("use_sim3", [False, True])
def test_solve_pgo_matches_jax(rng, use_sim3):
    if use_sim3:
        graph, _, _ = _ring_graph(rng, drift=0.01, use_sim3=True,
                                  scale_drift=0.01)
        iters = 30
    else:
        graph, _, _ = _ring_graph(rng, drift=0.02)
        iters = 25
    pj, cj = JP.solve_pgo(graph, iterations=iters, use_sim3=use_sim3)
    g = _graph_to_torch(graph)
    assert g.poses.dtype == torch.float64
    pt, ct = TP.solve_pgo(g, iterations=iters, use_sim3=use_sim3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-8)
    assert abs(float(ct) - float(cj)) <= 1e-8 * max(1.0, float(cj))
    # the loop is closed: far below the drifted graph's cost
    r0 = TP.solve_pgo(g, iterations=0, use_sim3=use_sim3)[1]
    assert float(ct) < 1e-2 * float(r0)
    again = TP.solve_pgo(g, iterations=iters, use_sim3=use_sim3)
    assert torch.equal(again[0], pt) and torch.equal(again[1], ct)
