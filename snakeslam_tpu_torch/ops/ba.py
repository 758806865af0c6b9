"""Bundle adjustment: Levenberg-Marquardt with point marginalization (Schur).

Counterpart of ``snakeslam_tpu/ops/ba.py`` (the reference's BARec /
BAPointOnly solvers, with the relative-pose-constraint factors between
keyframes).  The sparse problem has a fixed-shape per-point layout: each of
P point slots carries up to M observation slots.  Points are marginalized
exactly (closed-form batched 3x3 inverses), the reduced camera system
(6C x 6C) is built densely and solved by Cholesky, and the LM loop is
branchless: it always steps, keeps the best evaluated iterate with
``torch.where`` and runs ``iterations + 1`` passes, so no pass reads a
device value on the host.

Sums over observations land in C + 1 camera segments (the last one drops
invalid observations).  The JAX package sums them with ``segment_sum``; on
CUDA a scatter-add would sum in no fixed order, so every such sum here is a
contraction with a one-hot camera matrix (a matrix product, fixed order):
the result of a rerun is bit-identical.

Conventions: poses are world->camera, the update is T <- exp(delta) @ T,
the residual is proj(T x) - uv with a stereo third row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops.linalg import inv3x3, solve3x3, solve_psd
from snakeslam_tpu_torch.tracking.staging import upload


class BAProblem(NamedTuple):
    """Fixed-shape BA problem: C camera slots, P point slots, M obs/point."""

    cam_pose: torch.Tensor      # (C, 4, 4) world->camera
    cam_fixed: torch.Tensor     # (C,) bool — held constant (incl. gauge)
    cam_valid: torch.Tensor     # (C,) bool
    points: torch.Tensor        # (P, 3)
    point_valid: torch.Tensor   # (P,) bool
    obs_cam: torch.Tensor       # (P, M) int32 camera slot of each obs
    obs_uv: torch.Tensor        # (P, M, 2)
    obs_right: torch.Tensor     # (P, M) right-image x; < 0 => mono
    obs_weight: torch.Tensor    # (P, M) = 1/scale(octave)
    obs_valid: torch.Tensor     # (P, M) bool
    # relative pose constraints: residual log(T_j T_i^-1 M^-1)
    rpc_i: torch.Tensor         # (R,) int32
    rpc_j: torch.Tensor         # (R,) int32
    rpc_T: torch.Tensor         # (R, 4, 4) measured T_j @ T_i^-1
    rpc_weight: torch.Tensor    # (R, 6) per-axis weights (trans3, rot3)
    rpc_valid: torch.Tensor     # (R,) bool


def problem_to_device(cam_pose, cam_fixed, cam_valid, points, point_valid,
                      obs_cam, obs_uv, obs_right, obs_weight, obs_valid,
                      rpc_i, rpc_j, rpc_T, rpc_weight, rpc_valid,
                      device, float_dtype=np.float32) -> BAProblem:
    """Host numpy arrays -> a BAProblem on ``device`` (float fields of
    ``float_dtype``, slots int32, flags bool)."""
    f32, i32 = float_dtype, np.int32
    return BAProblem(
        cam_pose=upload(np.asarray(cam_pose, f32), device),
        cam_fixed=upload(np.asarray(cam_fixed, bool), device),
        cam_valid=upload(np.asarray(cam_valid, bool), device),
        points=upload(np.asarray(points, f32), device),
        point_valid=upload(np.asarray(point_valid, bool), device),
        obs_cam=upload(np.asarray(obs_cam, i32), device),
        obs_uv=upload(np.asarray(obs_uv, f32), device),
        obs_right=upload(np.asarray(obs_right, f32), device),
        obs_weight=upload(np.asarray(obs_weight, f32), device),
        obs_valid=upload(np.asarray(obs_valid, bool), device),
        rpc_i=upload(np.asarray(rpc_i, i32), device),
        rpc_j=upload(np.asarray(rpc_j, i32), device),
        rpc_T=upload(np.asarray(rpc_T, f32), device),
        rpc_weight=upload(np.asarray(rpc_weight, f32), device),
        rpc_valid=upload(np.asarray(rpc_valid, bool), device),
    )


def empty_rpc(device, dtype=torch.float32) -> dict:
    """The relative-pose-constraint fields of a problem that has none: one
    invalid slot."""
    return dict(
        rpc_i=torch.zeros(1, dtype=torch.int32, device=device),
        rpc_j=torch.zeros(1, dtype=torch.int32, device=device),
        rpc_T=torch.eye(4, dtype=dtype, device=device)[None],
        rpc_weight=torch.zeros((1, 6), dtype=dtype, device=device),
        rpc_valid=torch.zeros(1, dtype=torch.bool, device=device),
    )


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE3 for (v, w) tangent ordering: (..., 6, 6)."""
    R = T[..., :3, :3]
    tR = lie.hat(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(...) int indices in [0, n) -> (..., n) one-hot of ``dtype``."""
    ar = torch.arange(n, device=idx.device)
    return (idx[..., None] == ar).to(dtype)


# ---------------------------------------------------------------------------
# residuals / jacobians
# ---------------------------------------------------------------------------

def _point_residuals(problem: BAProblem, cam: Pinhole, bf, cam_pose, points):
    """Residuals r (P, M, 3), camera Jacobians A (P, M, 3, 6), point
    Jacobians B (P, M, 3, 3), validity (P, M), stereo flags (P, M)."""
    cidx = torch.clamp(problem.obs_cam, 0, cam_pose.shape[0] - 1).long()
    T = cam_pose[cidx]                      # (P, M, 4, 4)
    pc = (T[..., :3, :3] @ points[:, None, :, None])[..., 0] + T[..., :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_ok = z > 1e-4
    zs = torch.where(z_ok, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - bf * iz
    has_stereo = problem.obs_right > 0
    stereo_scale = torch.where(has_stereo, 1.0, 0.0)
    r = torch.stack(
        [u - problem.obs_uv[..., 0], v - problem.obs_uv[..., 1],
         torch.where(has_stereo, ur - problem.obs_right, 0.0)
         * stereo_scale],
        dim=-1,
    )
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    # d pc / d delta_cam = [I | -hat(pc)]
    dpc = torch.stack(
        [
            torch.stack([ones, zeros, zeros, zeros, z, -y], dim=-1),
            torch.stack([zeros, ones, zeros, -z, zeros, x], dim=-1),
            torch.stack([zeros, zeros, ones, y, -x, zeros], dim=-1),
        ],
        dim=-2,
    )  # (P, M, 3, 6)
    Jp = torch.stack(
        [
            torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], dim=-1),
            torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], dim=-1),
            torch.stack([cam.fx * iz, zeros, (-cam.fx * x + bf) * iz2],
                        dim=-1) * stereo_scale[..., None],
        ],
        dim=-2,
    )  # (P, M, 3, 3)
    A = Jp @ dpc
    B = Jp @ T[..., :3, :3]
    valid = (
        problem.obs_valid
        & problem.point_valid[:, None]
        & z_ok
        & (problem.obs_cam >= 0)
    )
    return r, A, B, valid, has_stereo


def _obs_chi2(r, weight, has_stereo):
    e2 = torch.where(has_stereo, torch.sum(r * r, dim=-1),
                     r[..., 0] ** 2 + r[..., 1] ** 2)
    return weight**2 * e2


def _rpc_residuals(problem: BAProblem, cam_pose):
    """Relative-pose residual per constraint: log(T_j T_i^-1 M^-1), with
    J wrt delta_j ~ I (left perturbation) and J wrt delta_i = -Ad(rel)."""
    C = cam_pose.shape[0]
    Ti = cam_pose[torch.clamp(problem.rpc_i, 0, C - 1).long()]
    Tj = cam_pose[torch.clamp(problem.rpc_j, 0, C - 1).long()]
    rel = Tj @ lie.se3_inverse(Ti)
    r = lie.se3_log(rel @ lie.se3_inverse(problem.rpc_T))
    Jj = torch.eye(6, dtype=r.dtype, device=r.device).expand(
        r.shape[:-1] + (6, 6))
    Ji = -se3_adjoint(rel)
    return r, Ji, Jj


def _huber_cost(chi2, delta_h, valid):
    """Summed Huber cost and sqrt(chi2)."""
    e = torch.sqrt(chi2 + 1e-12)
    c = torch.where(e <= delta_h, chi2, 2 * delta_h * e - delta_h**2)
    return torch.sum(torch.where(valid, c, 0.0)), e


def _rpc_cost(problem: BAProblem, rr):
    return torch.sum(torch.where(problem.rpc_valid[:, None],
                                 problem.rpc_weight * rr * rr, 0.0))


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

def ba_cost(problem: BAProblem, cam: Pinhole, bf, cam_pose, points,
            huber_delta_mono, huber_delta_stereo):
    r, _, _, valid, has_stereo = _point_residuals(
        problem, cam, bf, cam_pose, points)
    chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
    delta_h = torch.where(has_stereo, huber_delta_stereo, huber_delta_mono)
    cost, _ = _huber_cost(chi2, delta_h, valid)
    rr, _, _ = _rpc_residuals(problem, cam_pose)
    return cost + _rpc_cost(problem, rr)


# ---------------------------------------------------------------------------
# Schur pair scatter
# ---------------------------------------------------------------------------

_SCHUR_SCATTER_MAX_BYTES = 64 << 20


def _schur_pair_scatter(Y, Z, cidx, C):
    """sum_p Y_pm (Hpp^-1 Y_pn)^T summed into the camera pair table, as
    (C, C, 6, 6), for Y (P, M, 6, 3), Z (P, M, 3, 6) and the observations'
    camera slots cidx (P, M) (C drops an observation).

    Each point's observations are first placed in camera slots,
    Yc[p, a] = sum_m [cidx[p, m] == a] Y[p, m], then one contraction over
    (point, 3) gives every camera pair: a fixed-order matrix product
    instead of a scatter-add.  One shot when the placed (P, C + 1, 6, 3)
    temporaries stay under ~64 MB (LBA buckets); chunked over point slots
    above that (GBA-scale P), the chunks summed in order."""
    P = Y.shape[0]
    per_point = 2 * (C + 1) * 18 * Y.element_size()

    def pairs(Yk, Zk, ck):
        ok = _one_hot(ck, C + 1, Yk.dtype)
        Yc = torch.einsum("pma,pmik->paik", ok, Yk)[:, :C]
        Zc = torch.einsum("pma,pmkj->pakj", ok, Zk)[:, :C]
        return torch.einsum("paik,pbkj->abij", Yc, Zc)

    if P * per_point <= _SCHUR_SCATTER_MAX_BYTES:
        return pairs(Y, Z, cidx)
    Q = max(1, _SCHUR_SCATTER_MAX_BYTES // per_point)
    S = pairs(Y[:Q], Z[:Q], cidx[:Q])
    for k in range(Q, P, Q):
        S = S + pairs(Y[k:k + Q], Z[k:k + Q], cidx[k:k + Q])
    return S


# ---------------------------------------------------------------------------
# Schur-complement pieces (shared with parallel/multichip.py's sharded step)
# ---------------------------------------------------------------------------

def _reduced_camera_system(A, B, r, w, Hpp_inv, cidx, C):
    """The reduced camera system of the observations (P, M) with camera
    Jacobians A, point Jacobians B, residuals r, weights w, the points'
    inverse damped Hessians Hpp_inv (P, 3, 3) and camera slots cidx (C
    drops an observation): S = Hcc - sum Y Hpp^-1 Y^T as (C, C, 6, 6), the
    reduced gradient g_hat (C, 6), and Y (P, M, 6, 3) and g_p (P, 3) for
    the back-substitution.  Every segment sum is a one-hot contraction."""
    dtype = A.dtype
    g_p = torch.einsum("pmki,pm,pmk->pi", B, w, r)            # (P, 3)
    g_c_obs = torch.einsum("pmki,pm,pmk->pmi", A, w, r)       # (P, M, 6)
    Hcc_obs = torch.einsum("pmki,pm,pmkj->pmij", A, w, A)     # (P,M,6,6)
    Y = torch.einsum("pmki,pm,pmkj->pmij", A, w, B)           # (P,M,6,3)

    onehot = _one_hot(cidx, C + 1, dtype)                     # (P,M,C+1)
    g_c = torch.einsum("pma,pmi->ai", onehot, g_c_obs)[:C]
    Hcc = torch.einsum("pma,pmij->aij", onehot, Hcc_obs)[:C]

    # reduced gradient: g_c - sum_pm Y (Hpp^-1 g_p)
    hg = torch.einsum("pij,pj->pi", Hpp_inv, g_p)             # (P, 3)
    red = torch.einsum("pmij,pj->pmi", Y, hg)                 # (P, M, 6)
    g_hat = g_c - torch.einsum("pma,pmi->ai", onehot, red)[:C]

    # reduced camera system S = Hcc - sum Y Hpp^-1 Y^T, as (C, C, 6, 6)
    Z = torch.einsum("pij,pmkj->pmik", Hpp_inv, Y)            # (P,M,3,6)
    S = -_schur_pair_scatter(Y, Z, cidx, C)
    diag = torch.arange(C, device=A.device)
    S[diag, diag] += Hcc
    return S, g_hat, Y, g_p


def _add_rpc(problem: BAProblem, cam_pose, S, g_hat):
    """The relative-pose factors added to the reduced camera system as
    one-hot contractions (fixed order): (S, g_hat, the factors'
    residuals)."""
    C = cam_pose.shape[0]
    dtype = cam_pose.dtype
    Oi = _one_hot(torch.clamp(problem.rpc_i, 0, C - 1).long(), C, dtype)
    Oj = _one_hot(torch.clamp(problem.rpc_j, 0, C - 1).long(), C, dtype)
    rr, Ji, Jj = _rpc_residuals(problem, cam_pose)
    wr = torch.where(problem.rpc_valid[:, None], problem.rpc_weight, 0.0)
    Hii = torch.einsum("rki,rk,rkj->rij", Ji, wr, Ji)
    Hjj = torch.einsum("rki,rk,rkj->rij", Jj, wr, Jj)
    Hij = torch.einsum("rki,rk,rkj->rij", Ji, wr, Jj)
    gi = torch.einsum("rki,rk,rk->ri", Ji, wr, rr)
    gj = torch.einsum("rki,rk,rk->ri", Jj, wr, rr)
    S = S + (torch.einsum("ra,rb,rij->abij", Oi, Oi, Hii)
             + torch.einsum("ra,rb,rij->abij", Oj, Oj, Hjj)
             + torch.einsum("ra,rb,rij->abij", Oi, Oj, Hij)
             + torch.einsum("ra,rb,rji->abij", Oj, Oi, Hij))
    return S, g_hat + Oi.mT @ gi + Oj.mT @ gj, rr


def _camera_step(S, g_hat, free, lam):
    """The camera update (C, 6) from the reduced system: LM-style diagonal
    damping, the constant cameras masked out, the dense 6C x 6C Cholesky
    solve.  S is damped in place.  S is symmetric positive definite after
    damping; a degenerate window gives NaN here, which the LBA commit
    drops."""
    C = S.shape[0]
    dtype, dev = S.dtype, S.device
    diag = torch.arange(C, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diagS = torch.diagonal(S[diag, diag], dim1=1, dim2=2)     # (C, 6)
    S[diag, diag] += (lam * torch.clamp(diagS, min=1e-8))[:, :, None] \
        * eye6
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[diag, diag] += eye6 * (1.0 - free)[:, None, None]
    g_hat = g_hat * free[:, None]
    S_dense = S.transpose(1, 2).reshape(6 * C, 6 * C)
    eye_s = torch.eye(6 * C, dtype=dtype, device=dev)
    delta_c = -solve_psd(S_dense + 1e-8 * eye_s,
                         g_hat.reshape(-1)).reshape(C, 6)
    return delta_c * free[:, None]


def _back_substitute(problem: BAProblem, points, delta_c, Hpp_inv, Y, g_p,
                     cidx):
    """The point update delta_p = -Hpp^-1 (g_p + sum_m Y^T delta_c)."""
    C = delta_c.shape[0]
    dc = delta_c[torch.clamp(cidx, max=C - 1)]
    dc = torch.where((cidx < C)[..., None], dc, 0.0)
    ytd = torch.einsum("pmij,pmi->pj", Y, dc)
    delta_p = -torch.einsum("pij,pj->pi", Hpp_inv, g_p + ytd)
    return torch.where(problem.point_valid[:, None], points + delta_p,
                       points)


# ---------------------------------------------------------------------------
# the LM solver
# ---------------------------------------------------------------------------

def solve_ba(
    problem: BAProblem,
    cam: Pinhole,
    bf: torch.Tensor,
    iterations: int = 3,
    huber_mono: float = 2.1,
    huber_stereo: float = 2.3,
    lm_lambda0: float = 1e-4,
    optimize_points: bool = True,
):
    """Levenberg-Marquardt BA with exact point marginalization.

    Returns (cam_pose, points, final_cost).  With optimize_points=False
    it is motion-only BA over the window (all points constant)."""
    C = problem.cam_pose.shape[0]
    dtype = problem.cam_pose.dtype
    dev = problem.cam_pose.device
    free = (problem.cam_valid & (~problem.cam_fixed)).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def build_normal_eqs(cam_pose, points, lam):
        r, A, B, valid, has_stereo = _point_residuals(
            problem, cam, bf, cam_pose, points)
        chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
        delta_h = torch.where(has_stereo, huber_stereo, huber_mono)
        # Huber cost at the current iterate, from the same residual pass
        cost_cur, e = _huber_cost(chi2, delta_h, valid)
        huber = torch.clamp(delta_h / e, max=1.0)
        w = torch.where(valid, problem.obs_weight**2 * huber, 0.0)  # (P, M)

        # per-point 3x3 Hessian, damped, closed-form inverse
        Hpp = torch.einsum("pmki,pm,pmkj->pij", B, w, B)
        Hpp = Hpp + (lam * torch.clamp(
            torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-8))[:, :, None] * eye3
        Hpp = Hpp + 1e-9 * eye3
        Hpp_inv = inv3x3(Hpp)

        cidx = torch.where(valid, problem.obs_cam.long(), C)      # C = drop
        S, g_hat, Y, g_p = _reduced_camera_system(A, B, r, w, Hpp_inv, cidx,
                                                  C)
        S, g_hat, rr = _add_rpc(problem, cam_pose, S, g_hat)
        cost_cur = cost_cur + _rpc_cost(problem, rr)
        return S, g_hat, Hpp_inv, Y, g_p, cidx, cost_cur

    def apply_step(cam_pose, points, S, g_hat, Hpp_inv, Y, g_p, cidx, lam):
        delta_c = _camera_step(S, g_hat, free, lam)
        new_cam = lie.orthonormalize(lie.se3_exp(delta_c) @ cam_pose)
        if not optimize_points:
            return new_cam, points
        return new_cam, _back_substitute(problem, points, delta_c, Hpp_inv,
                                         Y, g_p, cidx)

    # one residual/Jacobian pass per iteration: always step, keep the best
    # evaluated iterate; iterations + 1 passes (the last evaluates the last
    # step's cost, its own step is discarded by the best selection)
    big = torch.full((), torch.finfo(dtype).max, dtype=dtype, device=dev)
    lam = torch.full((), lm_lambda0, dtype=dtype, device=dev)
    cam_pose, points = problem.cam_pose, problem.points
    prev_cost = best_cost = big
    best_cam, best_pts = cam_pose, points
    for _ in range(iterations + 1):
        S, g_hat, Hpp_inv, Y, g_p, cidx, cost_cur = build_normal_eqs(
            cam_pose, points, lam)
        improved = cost_cur < best_cost
        best_cam = torch.where(improved, cam_pose, best_cam)
        best_pts = torch.where(improved, points, best_pts)
        best_cost = torch.where(improved, cost_cur, best_cost)
        lam_step = lam
        lam = torch.where(cost_cur <= prev_cost, lam * 0.5, lam * 4.0)
        prev_cost = cost_cur
        cam_pose, points = apply_step(cam_pose, points, S, g_hat, Hpp_inv,
                                      Y, g_p, cidx, lam_step)
    return best_cam, best_pts, best_cost


def solve_point_only(
    problem: BAProblem,
    cam: Pinhole,
    bf: torch.Tensor,
    iterations: int = 4,
    huber_mono: float = 2.1,
    huber_stereo: float = 2.3,
):
    """Point-only BA (cameras constant): independent per-point 3x3 GN
    solves, fully batched.

    Each point's normal equations are formed and solved in float64 from
    the float32 residuals and Jacobians.  A point seen once, mono, has a
    rank-2 system held only by the 1e-6 damping; in float32 the rounding
    of its gradient, divided by that damping, moves it metres along its
    viewing ray (one such point reached 1.5e26 m and turned the next full
    BA to NaN).  The JAX package keeps float32 here."""
    f64 = torch.float64
    eye3 = torch.eye(3, dtype=f64, device=problem.points.device)
    points = problem.points
    for _ in range(iterations):
        r, _, B, valid, has_stereo = _point_residuals(
            problem, cam, bf, problem.cam_pose, points)
        chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
        delta_h = torch.where(has_stereo, huber_stereo, huber_mono)
        e = torch.sqrt(chi2 + 1e-12)
        huber = torch.clamp(delta_h / e, max=1.0)
        w = torch.where(valid, problem.obs_weight**2 * huber, 0.0)
        B64, w64 = B.to(f64), w.to(f64)
        Hpp = torch.einsum("pmki,pm,pmkj->pij", B64, w64, B64) + 1e-6 * eye3
        g_p = torch.einsum("pmki,pm,pmk->pi", B64, w64, r.to(f64))
        delta = -solve3x3(Hpp, g_p).to(points.dtype)
        has_obs = torch.sum(w, dim=1) > 0
        points = torch.where((problem.point_valid & has_obs)[:, None],
                             points + delta, points)
    return points


def classify_outliers(
    problem: BAProblem,
    cam: Pinhole,
    bf: torch.Tensor,
    cam_pose: torch.Tensor,
    points: torch.Tensor,
    chi2_mono: float = 2.1**2,
    chi2_stereo: float = 2.3**2,
):
    """Observation-level chi2 outlier mask (True = outlier), the
    reference's post-solve classification."""
    r, _, _, valid, has_stereo = _point_residuals(
        problem, cam, bf, cam_pose, points)
    chi2 = _obs_chi2(r, problem.obs_weight, has_stereo)
    th = torch.where(has_stereo, chi2_stereo, chi2_mono)
    return valid & (chi2 > th)
