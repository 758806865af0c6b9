"""IMU functions: preintegration, linear init solvers, decoupled chain solver.

Counterpart of ``snakeslam_tpu/ops/imu.py`` (the reference's
Keyframe preintegration, SolveGlobalGyroBias, SolveScaleGravityLinear /
SolveScaleGravityBiasLinear and DecoupledImuSolver).  The tensor functions
are plain functions on tensors of any float dtype and device:
preintegration is a loop over the padded sample axis, batched over leading
keyframe dimensions; the linear initializers are batched least squares over
keyframe pairs / triplets; the decoupled solver is a Gauss-Newton over the
keyframe chain whose dense Jacobian comes from ``torch.func.jacfwd`` (the
state is small: 3 velocities per keyframe + 9 shared parameters).  The
state solver calls them in float64.  On the card the chain solve is a
compiled program (``solve_imu_chain``, ``utils/graphs.py``): one captured
CUDA graph replayed per call, keyed by its flags, iteration count and
weights (all static) and the chain's bucket.

The numpy twins at the end are what the per-keyframe and per-frame paths
use: a handful of 3x3 products costs less on the host than one kernel
launch, and the chain arrays grow with every keyframe.

Conventions:
  * Body/world rotations R_wb (body -> world); p, v in world.
  * Preintegration deltas follow Forster et al. (TRO'16) with first-order
    bias Jacobians.
  * Gravity vector g points "down" in world coords (|g| = 9.81).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.ops.linalg import solve3x3, solve_lu
from snakeslam_tpu_torch.utils import graphs

GRAVITY = 9.81


class Preint(NamedTuple):
    """Preintegrated IMU delta between two frames/keyframes (tensors from
    the tensor functions, numpy arrays from ``preintegrate_np``)."""

    dR: object      # (..., 3, 3)
    dv: object      # (..., 3)
    dp: object      # (..., 3)
    dt: object      # (...)
    # first-order bias Jacobians
    J_R_bg: object  # (..., 3, 3)
    J_v_bg: object  # (..., 3, 3)
    J_v_ba: object  # (..., 3, 3)
    J_p_bg: object  # (..., 3, 3)
    J_p_ba: object  # (..., 3, 3)


def _mv(A, x):
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i), of
    tensors or of numpy arrays."""
    return (A @ x[..., None])[..., 0]


def _right_jacobian(w):
    """SO3 right Jacobian Jr(w)."""
    theta = lie.safe_norm(w)
    W = lie.hat(w)
    W2 = W @ W
    b = lie._one_minus_cos_over_x2(theta)[..., None, None]
    c = lie._x_minus_sin_over_x3(theta)[..., None, None]
    return lie._eye3_like(W) - b * W + c * W2


def preintegrate(omega: torch.Tensor, acc: torch.Tensor, dt: torch.Tensor,
                 mask: torch.Tensor, bg: torch.Tensor,
                 ba: torch.Tensor) -> Preint:
    """Integrate a padded window of IMU samples.

    Args:
      omega, acc: (..., S, 3) gyro (rad/s) / accelerometer (m/s^2) samples.
      dt: (..., S) per-sample integration interval (s); mask: (..., S) valid.
      bg, ba: (3,) gyro / accelerometer bias estimates.
    Leading dimensions are a batch of windows (one per keyframe edge)
    integrated together: the loop runs over the S samples only.
    """
    dtype, dev = omega.dtype, omega.device
    lead = omega.shape[:-2]
    S = omega.shape[-2]
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3))
    Z3 = torch.zeros(lead + (3, 3), dtype=dtype, device=dev)
    z = torch.zeros(lead + (3,), dtype=dtype, device=dev)
    dR, dv, dp, T = I3, z, z, torch.zeros(lead, dtype=dtype, device=dev)
    JRbg = Jvbg = Jvba = Jpbg = Jpba = Z3
    for k in range(S):
        h = torch.where(mask[..., k], dt[..., k], 0.0)
        hv, hm = h[..., None], h[..., None, None]
        wb = omega[..., k, :] - bg
        ab = acc[..., k, :] - ba
        dR_inc = lie.so3_exp(wb * hv)
        Jr = _right_jacobian(wb * hv)
        hat_ab = lie.hat(ab)
        Rab = _mv(dR, ab)
        # position/velocity first (use dR at the interval start)
        dp = dp + dv * hv + 0.5 * Rab * hv * hv
        Jpbg = Jpbg + Jvbg * hm - 0.5 * dR @ hat_ab @ JRbg * hm * hm
        Jpba = Jpba + Jvba * hm - 0.5 * dR * hm * hm
        dv = dv + Rab * hv
        Jvbg = Jvbg - dR @ hat_ab @ JRbg * hm
        Jvba = Jvba - dR * hm
        # rotation last
        JRbg = dR_inc.mT @ JRbg - Jr * hm
        dR = dR @ dR_inc
        T = T + h
    return Preint(dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba)


# batch over keyframe windows: (K, S, 3) samples -> Preint with leading K
preintegrate_batch = preintegrate


def preint_with_bias_correction(p: Preint, dbg, dba):
    """First-order-corrected deltas for a bias change (dbg, dba)."""
    dR = p.dR @ lie.so3_exp(_mv(p.J_R_bg, dbg))
    dv = p.dv + _mv(p.J_v_bg, dbg) + _mv(p.J_v_ba, dba)
    dp = p.dp + _mv(p.J_p_bg, dbg) + _mv(p.J_p_ba, dba)
    return dR, dv, dp


def predict(p: Preint, R_i, v_i, p_i, g):
    """Forward state prediction across the preintegrated interval (all
    tensors, or all numpy arrays with a ``preintegrate_np`` delta)."""
    dt = p.dt
    R_j = R_i @ p.dR
    v_j = v_i + g * dt + _mv(R_i, p.dv)
    p_j = p_i + v_i * dt + 0.5 * g * dt * dt + _mv(R_i, p.dp)
    return R_j, v_j, p_j


# ---------------------------------------------------------------------------
# gyro bias: GN over keyframe rotation pairs (SolveGlobalGyroBias parity)
# ---------------------------------------------------------------------------

def solve_gyro_bias(
    R_i: torch.Tensor,       # (K, 3, 3) body->world at interval starts
    R_j: torch.Tensor,       # (K, 3, 3) at interval ends
    dR: torch.Tensor,        # (K, 3, 3) preintegrated (at current bias)
    J_R_bg: torch.Tensor,    # (K, 3, 3)
    valid: torch.Tensor,     # (K,)
):
    """One GN step for the shared gyro bias increment.

    Residual per pair: r = Log( (dR Exp(J dbg))^T R_i^T R_j ).
    Returns (dbg (3,), rms residual before the step).
    """
    rel = dR.mT @ R_i.mT @ R_j
    r = lie.so3_log(rel)                       # (K, 3)
    # r(dbg) = Log(Exp(-J_R_bg dbg) Exp(r)): left perturbation, so
    # dr/d(dbg) = -Jl_inv(r) J_R_bg with Jl_inv(r) = Jr_inv(-r)
    J = -_right_jacobian_inv(-r) @ J_R_bg      # (K, 3, 3)
    w = valid.to(r.dtype)
    H = torch.einsum("kij,k,kil->jl", J, w, J)
    b = torch.einsum("kij,k,ki->j", J, w, r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    dbg = solve3x3(H + 1e-9 * eye, -b)
    rms = torch.sqrt(
        torch.sum(w * torch.sum(r * r, dim=-1))
        / torch.clamp(torch.sum(w), min=1.0))
    return dbg, rms


def _right_jacobian_inv(w):
    theta = lie.safe_norm(w)
    W = lie.hat(w)
    W2 = W @ W
    A = lie._sinc(theta)
    B = lie._one_minus_cos_over_x2(theta)
    small = theta < 0.1
    th2 = torch.where(small, torch.ones_like(theta), theta * theta)
    coef = torch.where(small, (1.0 / 12.0) * (1.0 + th2 / 60.0),
                       (1.0 - A / (2.0 * B)) / th2)
    return lie._eye3_like(W) + 0.5 * W + coef[..., None, None] * W2


# ---------------------------------------------------------------------------
# scale / gravity / acc-bias: linear solve over keyframe triplets
# (SolveScaleGravityLinear / SolveScaleGravityBiasLinear parity)
# ---------------------------------------------------------------------------

def solve_scale_gravity(
    R: torch.Tensor,         # (K, 3, 3) body->world (visual, unscaled)
    p: torch.Tensor,         # (K, 3) camera centers (visual, unscaled)
    dt12: torch.Tensor,      # (K-2,) preint dt between i,i+1
    dt23: torch.Tensor,      # (K-2,) between i+1,i+2
    dp12: torch.Tensor,      # (K-2, 3) preintegrated position deltas
    dp23: torch.Tensor,
    dv12: torch.Tensor,      # (K-2, 3)
    valid: torch.Tensor,     # (K-2,)
    Jp12_ba: torch.Tensor | None = None,   # (K-2, 3, 3) bias Jacobians
    Jp23_ba: torch.Tensor | None = None,
    Jv12_ba: torch.Tensor | None = None,
    with_acc_bias: bool = False,
    R_cam: torch.Tensor | None = None,     # (K, 3, 3) camera->world
    t_cb: torch.Tensor | None = None,      # (3,) body origin in camera frame
    with_lever: bool = False,
):
    """Linear estimation of scale s, gravity g (and optionally acc bias).

    From the preintegration equations with velocities eliminated across each
    consecutive keyframe triplet (i, j, k):

      s * [(pk-pj) - (pj-pi) * dt23/dt12]
        + g * [-0.5 * dt23 * (dt12 + dt23)]  (times identity)
        (+ ba-Jacobian terms)
      = R_i dp12 * (-dt23/dt12) + R_i dv12 * dt23 + R_j dp23
        (- lever-arm term, see below)

    Camera-IMU extrinsics: the body position is affine in the visual scale,
    p_wb = s * p_wc + R_wc t_cb, so the rotation chain R must be BODY
    rotations (R_wb = R_wc R_cb^-1) and the known lever contribution

        [(R_wc_k - R_wc_j) - (R_wc_j - R_wc_i) * dt23/dt12] @ t_cb

    moves to the right-hand side.  Identity extrinsics reduce exactly to
    the lever-free equations.

    Returns (s, g (3,), ba (3,), residual_rms).
    """
    dtype, dev = p.dtype, p.device
    p_i, p_j, p_k = p[:-2], p[1:-1], p[2:]
    R_i, R_j = R[:-2], R[1:-1]
    ratio = dt23 / dt12

    lam = (p_k - p_j) - (p_j - p_i) * ratio[:, None]           # (K2, 3) * s
    beta = (-0.5 * dt23 * (dt12 + dt23))[:, None, None] * torch.eye(
        3, dtype=dtype, device=dev)                            # (K2, 3, 3) * g
    gamma = (-_mv(R_i, dp12) * ratio[:, None]
             + _mv(R_i, dv12) * dt23[:, None] + _mv(R_j, dp23))
    if with_lever:
        arm = _mv(R_cam, t_cb)
        arm_i, arm_j, arm_k = arm[:-2], arm[1:-1], arm[2:]
        gamma = gamma - ((arm_k - arm_j) - (arm_j - arm_i) * ratio[:, None])
    if with_acc_bias:
        # d(gamma)/d(ba): the preint deltas shift by J_*_ba @ ba
        Aba = (-(R_i @ Jp12_ba) * ratio[:, None, None]
               + (R_i @ Jv12_ba) * dt23[:, None, None] + R_j @ Jp23_ba)
        A = torch.cat([lam[:, :, None], beta, -Aba], dim=2)    # (K2, 3, 7)
        nu = 7
    else:
        A = torch.cat([lam[:, :, None], beta], dim=2)          # (K2, 3, 4)
        nu = 4
    w = valid.to(dtype)
    Af = (A * w[:, None, None]).reshape(-1, nu)
    bf = (gamma * w[:, None]).reshape(-1)
    H = Af.T @ Af
    rhs = Af.T @ bf
    # pivoted LU, not Cholesky: H = Af^T Af mixes scale/gravity/bias
    # columns whose magnitudes differ by orders of magnitude, and this
    # solve runs once per VI-init stage (cold path, robustness over speed;
    # the caller reads the scale on the host right after)
    x = torch.linalg.solve(
        H + 1e-9 * torch.eye(nu, dtype=dtype, device=dev), rhs)
    s = x[0]
    g = x[1:4]
    ba = x[4:7] if with_acc_bias else torch.zeros(3, dtype=dtype, device=dev)
    resid = Af @ x - bf
    rms = torch.sqrt(torch.mean(resid ** 2))
    return s, g, ba, rms


def velocities_from_pairs(R, p, dt, dp, valid, s, g, dv=None):
    """Closed-form per-KF velocities given scale and gravity:
    v_i = (s (p_j - p_i) - 0.5 g dt^2 - R_i dp) / dt  for each pair (i, j);
    the last keyframe propagates the final pair through the velocity
    equation v_j = v_i + g dt + R_i dv.  dv is the preintegrated velocity
    (specific force) delta per edge; it contains -g dt, so omitting it
    would bias the last velocity by ~|g| dt."""
    p_i, p_j = p[:-1], p[1:]
    R_i = R[:-1]
    num = (s * (p_j - p_i) - 0.5 * g[None, :] * (dt ** 2)[:, None]
           - _mv(R_i, dp))
    v = num / torch.clamp(dt, min=1e-6)[:, None]
    v = torch.where(valid[:, None], v, 0.0)
    v_last = v[-1] + g * dt[-1]
    if dv is not None:
        v_last = v_last + R_i[-1] @ dv[-1]
    return torch.cat([v, v_last[None]], dim=0)


# ---------------------------------------------------------------------------
# decoupled chain solver (DecoupledImuScene parity)
# ---------------------------------------------------------------------------

class ImuChain(NamedTuple):
    """Fixed-shape decoupled VI problem over the keyframe chain (K slots)."""

    R: torch.Tensor        # (K, 3, 3) body->world (held constant: decoupled)
    p: torch.Tensor        # (K, 3) positions (constant, unscaled)
    v: torch.Tensor        # (K, 3) velocity states
    dt: torch.Tensor       # (K-1,) preint dt per edge
    dR: torch.Tensor       # (K-1, 3, 3)
    dv: torch.Tensor       # (K-1, 3)
    dp: torch.Tensor       # (K-1, 3)
    J_R_bg: torch.Tensor   # (K-1, 3, 3)
    J_v_bg: torch.Tensor   # (K-1, 3, 3)
    J_v_ba: torch.Tensor   # (K-1, 3, 3)
    J_p_bg: torch.Tensor   # (K-1, 3, 3)
    J_p_ba: torch.Tensor   # (K-1, 3, 3)
    edge_valid: torch.Tensor  # (K-1,)


def chain_functions(
    chain: ImuChain, bg0, ba0, g0, s0,
    weight_R: float = 1000.0, weight_P: float = 100.0,
    weight_V: float = 10.0, prior_bias_weight: float = 0.0,
):
    """The chain problem's pure functions of the state vector x (3K + 9):
    ``unpack(x) -> (v, bg, ba, g, s)`` and ``residuals(x)``."""
    K = chain.R.shape[0]
    dtype, dev = chain.R.dtype, chain.R.device
    # the gravity norm as the JAX package rounds it (through float32);
    # every constant is made on the device (no host copy: capturable)
    g_norm = torch.full((), GRAVITY, dtype=torch.float32,
                        device=dev).to(dtype)
    ex, ey = torch.eye(3, dtype=dtype, device=dev)[:2]

    def unpack(x):
        v = x[: 3 * K].reshape(K, 3)
        bg = bg0 + x[3 * K: 3 * K + 3]
        ba = ba0 + x[3 * K + 3: 3 * K + 6]
        # gravity via 2-dof rotation of the current direction
        theta = x[3 * K + 6: 3 * K + 8]
        g_dir = g0 / torch.clamp(torch.linalg.norm(g0), min=1e-9)
        # two tangent directions orthogonal to g_dir
        b1 = torch.linalg.cross(g_dir, ex)
        b1 = torch.where(torch.linalg.norm(b1) < 1e-3,
                         torch.linalg.cross(g_dir, ey), b1)
        b1 = b1 / torch.clamp(torch.linalg.norm(b1), min=1e-9)
        b2 = torch.linalg.cross(g_dir, b1)
        g = g_norm * (lie.so3_exp(theta[0] * b1 + theta[1] * b2) @ g_dir)
        s = s0 * torch.exp(x[3 * K + 8])
        return v, bg, ba, g, s

    sqwR, sqwP, sqwV = (float(np.sqrt(w))
                        for w in (weight_R, weight_P, weight_V))
    sq_prior = float(np.sqrt(prior_bias_weight)) if prior_bias_weight > 0 \
        else 0.0

    def residuals(x):
        v, bg, ba, g, s = unpack(x)
        dbg = bg - bg0
        dba = ba - ba0
        R_i, R_j = chain.R[:-1], chain.R[1:]
        p_i, p_j = chain.p[:-1], chain.p[1:]
        v_i, v_j = v[:-1], v[1:]
        dt = chain.dt
        inv_dt = 1.0 / torch.clamp(dt, min=1e-4)

        dR_c = chain.dR @ lie.so3_exp(_mv(chain.J_R_bg, dbg))
        dv_c = chain.dv + _mv(chain.J_v_bg, dbg) + _mv(chain.J_v_ba, dba)
        dp_c = chain.dp + _mv(chain.J_p_bg, dbg) + _mv(chain.J_p_ba, dba)

        r_R = lie.so3_log(dR_c.mT @ R_i.mT @ R_j)
        r_v = _mv(R_i.mT, v_j - v_i - g[None] * dt[:, None]) - dv_c
        r_p = _mv(R_i.mT, s * (p_j - p_i) - v_i * dt[:, None]
                  - 0.5 * g[None] * (dt ** 2)[:, None]) - dp_c
        w = chain.edge_valid.to(dtype)[:, None] * inv_dt[:, None]
        r = torch.cat([r_R * sqwR * w, r_v * sqwV * w, r_p * sqwP * w],
                      dim=1).reshape(-1)
        if prior_bias_weight > 0:
            r = torch.cat([r, sq_prior * torch.cat([dbg, dba])])
        return r

    return unpack, residuals


def _solve_imu_chain(
    chain: ImuChain,
    bg0: torch.Tensor, ba0: torch.Tensor, g0: torch.Tensor, s0: torch.Tensor,
    weight_R: float = 1000.0,
    weight_P: float = 100.0,
    weight_V: float = 10.0,
    solve_bg: bool = True,
    solve_ba: bool = True,
    solve_velocity: bool = True,
    solve_gravity: bool = True,
    solve_scale: bool = False,
    iterations: int = 3,
    prior_bias_weight: float = 0.0,
):
    """Gauss-Newton over {velocities, bg, ba, gravity direction, log-scale}.

    Residuals per chain edge (i, j), following the decoupled formulation
    (visual poses R, p constant; weights R/P/V):
      r_R = Log((dR Exp(J dbg))^T R_i^T R_j)                    * sqrt(wR)/dt
      r_v = R_i^T (v_j - v_i - g dt) - (dv + Jvbg dbg + Jvba dba) * sqrt(wV)/dt
      r_p = R_i^T (s (p_j - p_i) - v_i dt - 0.5 g dt^2)
            - (dp + Jpbg dbg + Jpba dba)                         * sqrt(wP)/dt

    The full dense Jacobian is assembled with forward-mode differentiation
    (``torch.func.jacfwd``): the state is tiny (3K + 9) and this runs only
    in initialization / refinement.  Masked columns and the 1e-6 damping
    keep unsolved and padded states where they are.
    Returns dict(v, bg, ba, g, s, cost).

    ``solve_imu_chain`` is this as a compiled program: the weights, the
    five ``solve_*`` flags, ``iterations`` and ``prior_bias_weight`` are
    static; the chain and the four priors are tensors.  Its outputs are
    the graph's buffers: read them before the next call.
    """
    K = chain.R.shape[0]
    dtype, dev = chain.R.dtype, chain.R.device
    unpack, residuals = chain_functions(
        chain, bg0, ba0, g0, s0, weight_R, weight_P, weight_V,
        prior_bias_weight)
    n_state = 3 * K + 9
    mask = torch.cat([
        torch.full((n,), 1.0 if on else 0.0, dtype=dtype, device=dev)
        for n, on in ((3 * K, solve_velocity), (3, solve_bg), (3, solve_ba),
                      (2, solve_gravity), (1, solve_scale))])
    eye = torch.eye(n_state, dtype=dtype, device=dev)
    jac = torch.func.jacfwd(residuals)

    # velocities enter the state absolutely (not as increments)
    x = torch.cat([chain.v.reshape(-1),
                   torch.zeros(9, dtype=dtype, device=dev)])
    for _ in range(iterations):
        r = residuals(x)
        J = jac(x) * mask[None, :]
        H = J.T @ J + 1e-6 * eye
        b = J.T @ r
        # pivoted LU (see solve_scale_gravity): velocity/bias/gravity
        # blocks make H too ill-conditioned for a float32 Cholesky
        x = x - mask * solve_lu(H, b)
    v, bg, ba, g, s = unpack(x)
    cost = torch.sum(residuals(x) ** 2)
    return dict(v=v, bg=bg, ba=ba, g=g, s=s, cost=cost)


solve_imu_chain = graphs.compiled(
    _solve_imu_chain,
    static=("weight_R", "weight_P", "weight_V", "solve_bg", "solve_ba",
            "solve_velocity", "solve_gravity", "solve_scale", "iterations",
            "prior_bias_weight"),
    name="imu_chain_solve")


# ---------------------------------------------------------------------------
# host helpers: buckets and the numpy twins
#
# The VI init state machine calls the solvers above once per keyframe with
# chain arrays whose lengths grow every call; the callers pad them to
# power-of-two buckets with valid masks so the shapes stay few, and the tiny
# closed-form pieces run in numpy (no device at all).
# ---------------------------------------------------------------------------


def _pow2_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def preintegrate_np(omega, acc, dt, bg, ba) -> Preint:
    """Host preintegration (numpy float64), matching ``preintegrate``.

    Preintegration is sequential 3x3 work over at most a few hundred
    samples: the host loop costs ~0.1 ms, while the tensor loop is tens of
    kernel launches a sample, and the VI state machine re-preintegrates
    every edge after every bias update (RecomputeWeights)."""
    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)
    I3 = np.eye(3)
    dR = I3.copy()
    dv = np.zeros(3)
    dp = np.zeros(3)
    T = 0.0
    JRbg = np.zeros((3, 3)); Jvbg = np.zeros((3, 3))
    Jvba = np.zeros((3, 3)); Jpbg = np.zeros((3, 3))
    Jpba = np.zeros((3, 3))

    def _hat(w):
        return np.array([[0.0, -w[2], w[1]],
                         [w[2], 0.0, -w[0]],
                         [-w[1], w[0], 0.0]])

    for w, a, h in zip(np.asarray(omega, np.float64),
                       np.asarray(acc, np.float64),
                       np.asarray(dt, np.float64)):
        wb = (w - bg) * h
        ab = a - ba
        th = float(np.linalg.norm(wb))
        W = _hat(wb)
        W2 = W @ W
        if th < 1e-8:
            dR_inc = I3 + W + 0.5 * W2
            Jr = I3 - 0.5 * W + W2 / 6.0
        else:
            s, c = np.sin(th), np.cos(th)
            dR_inc = I3 + (s / th) * W + ((1 - c) / th**2) * W2
            Jr = I3 - ((1 - c) / th**2) * W + ((th - s) / th**3) * W2
        hat_ab = _hat(ab)
        dp = dp + dv * h + 0.5 * (dR @ ab) * h * h
        Jpbg = Jpbg + Jvbg * h - 0.5 * dR @ hat_ab @ JRbg * h * h
        Jpba = Jpba + Jvba * h - 0.5 * dR * h * h
        dv = dv + (dR @ ab) * h
        Jvbg = Jvbg - dR @ hat_ab @ JRbg * h
        Jvba = Jvba - dR * h
        JRbg = dR_inc.T @ JRbg - Jr * h
        dR = dR @ dR_inc
        T = T + h
    return Preint(dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba)


def so3_log_np(R):
    """Batched numpy SO3 log map (host-side twin of lie.so3_log for the
    small rotations of gyro residuals)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    w = np.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    s = 2.0 * np.sin(theta)
    # small angle: w/2 is already the log; near pi fall back through the
    # symmetric part (rare in these residuals — gyro errors are small)
    scale = np.where(theta[..., None] < 1e-7, 0.5,
                     theta[..., None] / np.maximum(s[..., None], 1e-12))
    return w * scale


def velocities_from_pairs_np(R, p, dt, dp, s, g, dv=None):
    """Numpy twin of velocities_from_pairs (closed form, ~20 elements —
    a device call costs more than the arithmetic)."""
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    dt = np.asarray(dt, np.float64)
    dp = np.asarray(dp, np.float64)
    p_i, p_j = p[:-1], p[1:]
    R_i = R[:-1]
    num = (s * (p_j - p_i) - 0.5 * g[None, :] * (dt**2)[:, None]
           - np.einsum("kij,kj->ki", R_i, dp))
    v = num / np.maximum(dt, 1e-6)[:, None]
    v_last = v[-1] + g * dt[-1]
    if dv is not None:
        v_last = v_last + R_i[-1] @ np.asarray(dv, np.float64)[-1]
    return np.concatenate([v, v_last[None]], axis=0)


def so3_exp_np(w):
    """Batched numpy SO3 exp map (host-side twin of lie.so3_exp)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1] = -w[..., 2]; W[..., 0, 2] = w[..., 1]
    W[..., 1, 0] = w[..., 2];  W[..., 1, 2] = -w[..., 0]
    W[..., 2, 0] = -w[..., 1]; W[..., 2, 1] = w[..., 0]
    W2 = W @ W
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ths) / ths)[..., None, None]
    b = np.where(small, 0.5, (1 - np.cos(ths)) / ths**2)[..., None, None]
    return np.eye(3) + a * W + b * W2


def solve_gyro_bias_np(R_i, R_j, dR, J_R_bg, valid):
    """Host twin of solve_gyro_bias: one GN step for the shared gyro-bias
    increment (3x3 normal equations over at most hundreds of edges: less
    work than the launches a device call would cost)."""
    rel = np.swapaxes(dR, -1, -2) @ np.swapaxes(R_i, -1, -2) @ R_j
    r = so3_log_np(rel)                                     # (K, 3)
    # Jr_inv(-r): Jl_inv(r) = I + 0.5 W + (1/th^2 - (1+cos)/(2 th sin)) W^2
    th = np.linalg.norm(r, axis=-1)
    W = np.zeros(r.shape[:-1] + (3, 3))
    W[..., 0, 1] = -r[..., 2]; W[..., 0, 2] = r[..., 1]
    W[..., 1, 0] = r[..., 2];  W[..., 1, 2] = -r[..., 0]
    W[..., 2, 0] = -r[..., 1]; W[..., 2, 1] = r[..., 0]
    W2 = W @ W
    small = th < 1e-7
    ths = np.where(small, 1.0, th)
    c = np.where(
        small, 1.0 / 12.0,
        1.0 / ths**2 - (1.0 + np.cos(ths)) / (2.0 * ths * np.sin(ths)),
    )[..., None, None]
    Jl_inv = np.eye(3) + 0.5 * W + c * W2
    J = -Jl_inv @ np.asarray(J_R_bg, np.float64)            # (K, 3, 3)
    w = np.asarray(valid, np.float64)
    H = np.einsum("kij,k,kil->jl", J, w, J)
    b = np.einsum("kij,k,ki->j", J, w, r)
    dbg = np.linalg.solve(H + 1e-9 * np.eye(3), -b)
    rms = np.sqrt((w * (r * r).sum(-1)).sum() / max(w.sum(), 1.0))
    return dbg, rms
