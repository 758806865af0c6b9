"""Port parity: ops/descriptors.py, ops/linalg.py, ops/pose_solver.py.

Tolerances: the Hamming matrix is exact (bit-equal to the JAX matrix and to
the numpy oracle); the closed-form solves agree to rtol 1e-4 (f32, the
Schur elimination amplifies by the block condition number); the robust
pose refine agrees to pose atol 1e-4 with >= 99.9% identical inlier flags
(f32 reductions summed in another order); RANSAC draws differ between the
packages, so PnP is held against ground truth.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.core import lie as jlie
from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.ops import descriptors as jdesc
from snakeslam_tpu.ops import linalg as jlin
from snakeslam_tpu.ops import matching as jmatch
from snakeslam_tpu.ops import pose_solver as jps
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops import descriptors as tdesc
from snakeslam_tpu_torch.ops import linalg as tlin
from snakeslam_tpu_torch.ops import matching as tmatch
from snakeslam_tpu_torch.ops import pose_solver as tps
from snakeslam_tpu_torch.utils.convert import pose_obs_from_numpy

FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
BF = 458.654 * 0.11


def _desc(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 32),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n,m", [(64, 200), (300, 97)])
def test_hamming_matrix_exact(n, m):
    a, b = _desc(1, n), _desc(2, m)
    # near-duplicates: distances 0 and 256 occur
    b[:8] = a[:8]
    b[8] = ~a[9]
    ref = jdesc.hamming_np(a, b)
    bits_a, bits_b = jdesc.unpack_bits_np(a), jdesc.unpack_bits_np(b)
    jh = np.asarray(jdesc.hamming_matrix(jnp.asarray(bits_a),
                                         jnp.asarray(bits_b)))
    th = tdesc.hamming_matrix(torch.from_numpy(bits_a),
                              torch.from_numpy(bits_b)).numpy()
    assert th.dtype == np.int32
    assert np.array_equal(th, ref)
    assert np.array_equal(th, jh)


def test_unpack_bits_and_distance():
    a, b = _desc(3, 50), _desc(4, 50)
    tb = tdesc.unpack_bits(torch.from_numpy(a)).numpy()
    assert np.array_equal(tb, jdesc.unpack_bits_np(a))
    assert np.array_equal(tb, np.asarray(jdesc.unpack_bits(jnp.asarray(a))))
    d = tdesc.hamming_distance(torch.from_numpy(jdesc.unpack_bits_np(a)),
                               torch.from_numpy(jdesc.unpack_bits_np(b)))
    assert np.array_equal(d.numpy(), np.diag(jdesc.hamming_np(a, b)))


def _spd(seed, n, batch=32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32), \
        rng.normal(size=(batch, n)).astype(np.float32)


def test_inv3x3_and_solve3x3():
    A, b = _spd(5, 3)
    np.testing.assert_allclose(
        tlin.inv3x3(torch.from_numpy(A)).numpy(),
        np.asarray(jlin.inv3x3(jnp.asarray(A))), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        tlin.solve3x3(torch.from_numpy(A), torch.from_numpy(b)).numpy(),
        np.asarray(jlin.solve3x3(jnp.asarray(A), jnp.asarray(b))),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("solver", ["solve6x6_psd", "solve_psd"])
def test_psd_solves(solver):
    A, b = _spd(6, 6)
    np.testing.assert_allclose(
        getattr(tlin, solver)(torch.from_numpy(A), torch.from_numpy(b)).numpy(),
        np.asarray(getattr(jlin, solver)(jnp.asarray(A), jnp.asarray(b))),
        rtol=1e-4, atol=1e-6)


def _pose_problem(seed, n=400, outlier_frac=0.15, stereo_frac=0.5):
    """A test_pose_solver.py-style problem as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, size=(n, 3))
    pts[:, 2] += 12.0
    xi = rng.normal(size=6) * 0.1
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(xi, dtype=jnp.float64)))
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                   FY * pc[:, 1] / pc[:, 2] + CY], axis=1)
    uv += rng.normal(scale=0.3, size=uv.shape)
    right = np.full(n, -1.0)
    sel = rng.random(n) < stereo_frac
    right[sel] = uv[sel, 0] - BF / pc[sel, 2] + rng.normal(scale=0.3,
                                                         size=sel.sum())
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(15, 80, size=(n_out, 2)) * np.sign(
        rng.normal(size=(n_out, 2)))
    mask = np.ones(n, dtype=bool)
    mask[rng.choice(n, 20, replace=False)] = False
    weight = rng.uniform(0.5, 1.0, n)
    dxi = rng.normal(size=6) * np.array([0.05, 0.05, 0.05, 0.01, 0.01, 0.01])
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(dxi, dtype=jnp.float64))) @ T_true
    f = np.float32
    obs = jps.PoseObs(points=pts.astype(f), uv=uv.astype(f),
                      right=right.astype(f), weight=weight.astype(f),
                      mask=mask)
    return T0.astype(f), obs, T_true


def _jax_obs(obs):
    return jps.PoseObs(*(jnp.asarray(a) for a in obs))


JCAM = JPinhole(jnp.float32(FX), jnp.float32(FY), jnp.float32(CX),
                jnp.float32(CY))
TCAM = Pinhole.create(FX, FY, CX, CY)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("seed", [11, 12])
def test_robust_pose_refine_parity(prior, seed):
    T0, obs, T_true = _pose_problem(seed)
    kw = {}
    tkw = {}
    if prior:
        # a prior slightly off the truth, with nonzero split weights
        T_prior = (np.asarray(jlie.se3_exp(jnp.asarray(
            np.full(6, 2e-3), dtype=jnp.float64))) @ T_true).astype(np.float32)
        kw = dict(prior_T=jnp.asarray(T_prior),
                  prior_weight_rotation=jnp.float32(50.0),
                  prior_weight_translation=jnp.float32(20.0))
        tkw = dict(prior_T=torch.from_numpy(T_prior),
                   prior_weight_rotation=torch.tensor(50.0),
                   prior_weight_translation=torch.tensor(20.0))
    Tj, ij, nj = jps.robust_pose_refine(jnp.asarray(T0), _jax_obs(obs), JCAM,
                                        jnp.float32(BF), **kw)
    Tt, it, nt = tps.robust_pose_refine(
        torch.from_numpy(T0), pose_obs_from_numpy(obs, "cpu"), TCAM,
        torch.tensor(BF, dtype=torch.float32), **tkw)
    assert Tt.dtype == torch.float32
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    agree = (it.numpy() == np.asarray(ij)).mean()
    assert agree >= 0.999, agree
    assert abs(int(nt) - int(nj)) <= 1
    assert np.linalg.norm(Tt.numpy()[:3, 3] - T_true[:3, 3]) < 5e-3


def test_pnp_ransac_against_ground_truth():
    T0, obs, T_true = _pose_problem(21, n=300, outlier_frac=0.2,
                                    stereo_frac=0.0)
    gen = torch.Generator().manual_seed(3)
    T, inl, n_inl = tps.pnp_ransac(
        torch.from_numpy(obs.points), torch.from_numpy(obs.uv),
        torch.from_numpy(obs.mask), TCAM, gen)
    assert int(n_inl) > 150
    err_t = np.linalg.norm(T.numpy()[:3, 3] - T_true[:3, 3])
    assert err_t < 0.2, err_t          # DLT hypothesis before the polish
    n0, Tr, inlier, n_r = tps.pnp_refine_np(
        obs.points[obs.mask], obs.uv[obs.mask], TCAM,
        torch.tensor(BF, dtype=torch.float32), torch.Generator().manual_seed(4))
    assert inlier.shape == (int(obs.mask.sum()),)
    err_t = np.linalg.norm(Tr.numpy()[:3, 3] - T_true[:3, 3])
    assert err_t < 2e-3, err_t
    # the JAX package lands on the same pose from its own draws
    _, Tj, _, _ = jps.pnp_refine_np(obs.points[obs.mask], obs.uv[obs.mask],
                                    JCAM, BF, jax.random.PRNGKey(0))
    assert np.linalg.norm(np.asarray(Tj)[:3, 3] - T_true[:3, 3]) < 2e-3


def test_knn2_ratio_match_parity():
    a, b = _desc(31, 300), _desc(32, 260)
    rng = np.random.default_rng(33)
    # plant near-duplicates so the ratio test and cross check both fire
    src = rng.choice(300, 120, replace=False)
    b[:120] = a[src]
    flip = rng.integers(0, 256, size=(120, 4))
    bits_b = jdesc.unpack_bits_np(b)
    for k in range(120):
        bits_b[k, flip[k]] ^= 1
    bits_a = jdesc.unpack_bits_np(a)
    ij, dj = jmatch.knn2_ratio_match_np(bits_a, bits_b, ratio=0.8,
                                        max_dist=64)
    it, dt = tmatch.knn2_ratio_match_np(bits_a, bits_b, ratio=0.8,
                                        max_dist=64, device="cpu")
    assert (it >= 0).sum() > 100
    assert np.array_equal(it, ij)
    assert np.array_equal(dt, dj)
