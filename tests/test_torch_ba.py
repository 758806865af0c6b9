"""Schur-complement LM bundle adjustment: the port against the JAX package.

Problems come from tests/test_ba.py's ``_make_ba_problem`` (seeded numpy)
and go through both packages in float32.  Tolerances: cameras and points
within 1e-4, cost within 1e-4 relative (of max(cost, 1): the noise-free
problem's cost is ~1e-6 px^2, zero at f32 precision), outlier flags equal
on >= 99.5% of observations, point-only BA within 1e-4, the chunked and
one-shot Schur pair tables within 1e-5 of each other.

Noisy problems are solved with the LBA's 3 iterations.  Past that the LM
loop keeps the best evaluated iterate by a cost whose f32 evaluation noise
(~2e-3 on a cost of ~485) exceeds the change between late iterates, so the
two packages may keep different late iterates (1.3e-4 apart at 6
iterations on the noisy stereo problem); the cost still agrees there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.ops import ba as JBA
from snakeslam_tpu.ops import linalg as JLA
from snakeslam_tpu_torch.core.camera import Pinhole as TPinhole
from snakeslam_tpu_torch.ops import ba as TBA
from snakeslam_tpu_torch.ops import linalg as TLA
from test_ba import _make_ba_problem

FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
BF = 458.654 * 0.11
JCAM = JPinhole.create(FX, FY, CX, CY, dtype=jnp.float32)
TCAM = TPinhole.create(FX, FY, CX, CY)
JBF = jnp.float32(BF)
TBF = torch.tensor(BF, dtype=torch.float32)


def _f32(v):
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype == np.float64 else v


def _both(problem):
    """A JAX-package BAProblem (any dtype) -> (JAX f32, port f32)."""
    fields = {k: _f32(v) for k, v in problem._asdict().items()}
    return (JBA.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TBA.BAProblem(**{k: torch.from_numpy(v.copy())
                             for k, v in fields.items()}))


def _rpc_chain_problem(rng):
    """tests/test_ba.py's RPC-only chain: 6 cameras tied by exact
    relative-pose constraints, no visual observations."""
    from snakeslam_tpu.core import lie

    C = 6
    xi = [np.array([0.3 * c, 0.01 * c, 0.0, 0.0, 0.05 * c, 0.01 * c])
          for c in range(C)]
    cams_true = np.stack([np.asarray(lie.se3_exp(jnp.asarray(x)))
                          for x in xi])
    cam_noisy = cams_true.copy()
    for c in range(1, C):
        d = rng.normal(size=6) * 0.02
        cam_noisy[c] = np.asarray(lie.se3_exp(jnp.asarray(d))) @ cams_true[c]
    R = C - 1
    rpc_T = np.stack([cams_true[i + 1] @ np.linalg.inv(cams_true[i])
                      for i in range(R)])
    P, M = 4, 2
    fixed = np.zeros(C, dtype=bool)
    fixed[0] = True
    problem = JBA.BAProblem(
        cam_pose=cam_noisy, cam_fixed=fixed, cam_valid=np.ones(C, bool),
        points=np.zeros((P, 3)), point_valid=np.zeros(P, bool),
        obs_cam=np.full((P, M), -1, np.int32), obs_uv=np.zeros((P, M, 2)),
        obs_right=np.full((P, M), -1.0), obs_weight=np.ones((P, M)),
        obs_valid=np.zeros((P, M), bool),
        rpc_i=np.arange(R, dtype=np.int32),
        rpc_j=np.arange(1, R + 1, dtype=np.int32), rpc_T=rpc_T,
        rpc_weight=np.full((R, 6), 100.0), rpc_valid=np.ones(R, bool))
    return problem, cams_true


CASES = {
    # name: (problem kwargs, iterations)
    "mono": (dict(noise_px=0.0), 6),
    "noisy_stereo": (dict(noise_px=0.3, stereo=True), 3),
    "outliers": (dict(noise_px=0.2, outlier_frac=0.1), 3),
}


def _cost_close(c_t, c_j):
    return abs(c_t - c_j) <= 1e-4 * max(abs(c_j), 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_ba_matches_jax(rng, case):
    kw, iters = CASES[case]
    problem, _, _, _ = _make_ba_problem(rng, **kw)
    jp, tp = _both(problem)
    jc, jx, jcost = JBA.solve_ba(jp, JCAM, JBF, iterations=iters)
    tc, tx, tcost = TBA.solve_ba(tp, TCAM, TBF, iterations=iters)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    assert _cost_close(float(tcost), float(jcost)), (float(tcost),
                                                     float(jcost))
    # the cost function itself, at the solution
    c_j = JBA.ba_cost(jp, JCAM, JBF, jc, jx, 2.1, 2.3)
    c_t = TBA.ba_cost(tp, TCAM, TBF, torch.from_numpy(np.array(jc)),
                      torch.from_numpy(np.array(jx)), 2.1, 2.3)
    assert _cost_close(float(c_t), float(c_j)), (float(c_t), float(c_j))


def test_solve_ba_cost_agrees_past_the_lba_iterations(rng):
    """6 iterations on the noisy stereo problem: the kept iterate is
    decided by f32 cost noise (module docstring), the cost is not."""
    problem, _, _, _ = _make_ba_problem(rng, noise_px=0.3, stereo=True)
    jp, tp = _both(problem)
    _, _, jcost = JBA.solve_ba(jp, JCAM, JBF, iterations=6)
    _, _, tcost = TBA.solve_ba(tp, TCAM, TBF, iterations=6)
    assert _cost_close(float(tcost), float(jcost))


def test_classify_outliers_matches_jax(rng):
    problem, _, _, _ = _make_ba_problem(rng, noise_px=0.2, outlier_frac=0.1)
    jp, tp = _both(problem)
    jc, jx, _ = JBA.solve_ba(jp, JCAM, JBF, iterations=8)
    oj = np.asarray(JBA.classify_outliers(jp, JCAM, JBF, jc, jx))
    ot = TBA.classify_outliers(tp, TCAM, TBF, torch.from_numpy(np.array(jc)),
                               torch.from_numpy(np.array(jx))).numpy()
    valid = np.asarray(problem.obs_valid)
    assert (oj[valid] == ot[valid]).mean() >= 0.995
    assert oj[valid].sum() > 0


def test_solve_point_only_matches_jax(rng):
    problem, _, _, _ = _make_ba_problem(
        rng, pose_noise=0.0, point_noise=0.1, noise_px=0.0, n_fixed=8)
    jp, tp = _both(problem)
    jx = np.asarray(JBA.solve_point_only(jp, JCAM, JBF, iterations=6))
    tx = TBA.solve_point_only(tp, TCAM, TBF, iterations=6).numpy()
    np.testing.assert_allclose(tx, jx, atol=1e-4)


def test_rpc_only_chain_matches_jax(rng):
    problem, cams_true = _rpc_chain_problem(rng)
    jp, tp = _both(problem)
    jc, _, _ = JBA.solve_ba(jp, JCAM, JBF, iterations=10,
                            optimize_points=False)
    tc, _, _ = TBA.solve_ba(tp, TCAM, TBF, iterations=10,
                            optimize_points=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), cams_true, atol=1e-4)


def test_schur_pair_table_chunked_matches_one_shot(rng, monkeypatch):
    """The chunked path (reached by lowering the port's own threshold)
    against the one-shot path, and both against the JAX pair table."""
    C, P, M = 8, 200, 8
    Y = rng.normal(size=(P, M, 6, 3)).astype(np.float32)
    Z = rng.normal(size=(P, M, 3, 6)).astype(np.float32)
    cidx = rng.integers(0, C + 1, size=(P, M)).astype(np.int32)
    args = (torch.from_numpy(Y), torch.from_numpy(Z),
            torch.from_numpy(cidx).long(), C)
    one = TBA._schur_pair_scatter(*args)
    monkeypatch.setattr(TBA, "_SCHUR_SCATTER_MAX_BYTES", 16 << 10)
    chunked = TBA._schur_pair_scatter(*args)
    # the table sums 200 products of O(1) entries (entries up to ~60):
    # held to 1e-5 of its largest entry
    scale = float(one.abs().max())
    np.testing.assert_allclose(chunked.numpy(), one.numpy(),
                               atol=1e-5 * scale)
    ref = np.asarray(JBA._schur_pair_scatter(
        jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(cidx), C))
    np.testing.assert_allclose(one.numpy().reshape(C * C, 36), ref,
                               atol=1e-5 * scale)

    problem, _, _, _ = _make_ba_problem(rng, noise_px=0.3, stereo=True)
    _, tp = _both(problem)
    c_small, x_small, _ = TBA.solve_ba(tp, TCAM, TBF, iterations=3)
    monkeypatch.setattr(TBA, "_SCHUR_SCATTER_MAX_BYTES", 64 << 20)
    c_big, x_big, _ = TBA.solve_ba(tp, TCAM, TBF, iterations=3)
    # points lie 10-18 m away, where an f32 ulp is 1-2e-6 m: 1e-5 plus
    # 1e-6 of the value
    np.testing.assert_allclose(c_small.numpy(), c_big.numpy(), atol=1e-5)
    np.testing.assert_allclose(x_small.numpy(), x_big.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("diag", [(1.0, -1.0, 2.0), (4.0, 3.0, 2.0)])
def test_solve_psd_matches_jax_off_and_on_pd(diag):
    """A matrix that is not positive-definite gives NaN in both packages
    (the port raised before); a PD matrix solves within 1e-5."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    A = (Q @ np.diag(diag) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    b = rng.normal(size=3).astype(np.float32)
    xj = np.asarray(JLA.solve_psd(jnp.asarray(A), jnp.asarray(b)))
    xt = TLA.solve_psd(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    if min(diag) < 0:
        assert np.isnan(xj).all() and np.isnan(xt).all(), (xj, xt)
    else:
        np.testing.assert_allclose(xt, xj, atol=1e-5)
    D = np.diag(diag).astype(np.float32)
    xj = np.asarray(JLA.solve_psd(jnp.asarray(D), jnp.asarray(b)))
    xt = TLA.solve_psd(torch.from_numpy(D), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(np.isnan(xt), np.isnan(xj))
    np.testing.assert_allclose(xt[~np.isnan(xt)], xj[~np.isnan(xj)],
                               atol=1e-5)
