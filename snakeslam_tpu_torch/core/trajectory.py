"""Trajectory evaluation and TUM-format IO.

Replaces saiga's ``Trajectory::Scene`` ATE evaluation used by the reference's
end-of-run statistics (reference: Snake/Map/Map.cpp:432-484 TrajectoryError,
Snake/System/System.cpp:529-590 trajectory writers).  Host-side numpy: this is
offline evaluation, not a hot path.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: (N, 3) corresponding points.
      with_scale: if False, solve SE3 (scale fixed to 1).

    Returns: (s, R, t) with dst ≈ s * R @ src + t.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Absolute trajectory error after Umeyama alignment.

    Args:
      est, gt: (N, 3) matched positions (same timestamps).
      with_scale: Sim3 (True) or SE3 (False) alignment — the reference prints
        both ("ATE RMSE Sim3/SE3", Snake/System/Module.cpp:14-77).

    Returns: (rmse, scale) — rmse in gt units, the alignment scale.
    """
    if len(est) < 3:
        return float("nan"), 1.0
    s, R, t = umeyama(est, gt, with_scale=with_scale)
    aligned = (s * (R @ np.asarray(est, dtype=np.float64).T)).T + t
    err = aligned - np.asarray(gt, dtype=np.float64)
    rmse = float(np.sqrt((err**2).sum(axis=1).mean()))
    return rmse, s


# ---------------------------------------------------------------------------
# TUM trajectory format: "timestamp tx ty tz qx qy qz qw" per line
# ---------------------------------------------------------------------------

def write_tum(path, timestamps, positions, quats_wxyz):
    """Write a TUM-format trajectory (quaternions stored xyzw on disk)."""
    timestamps = np.asarray(timestamps)
    positions = np.asarray(positions)
    q = np.asarray(quats_wxyz)
    with open(path, "w") as f:
        for i in range(len(timestamps)):
            t = positions[i]
            f.write(
                f"{timestamps[i]:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[i, 1]:.9f} {q[i, 2]:.9f} {q[i, 3]:.9f} {q[i, 0]:.9f}\n"
            )


def read_tum(path):
    """Read a TUM-format trajectory -> (timestamps (N,), pos (N,3), quat_wxyz (N,4))."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            pos.append(vals[1:4])
            qx, qy, qz, qw = vals[4:8]
            quat.append([qw, qx, qy, qz])
    return np.array(ts), np.array(pos), np.array(quat)


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Match two timestamp arrays (nearest neighbor within max_dt).

    Returns (idx_a, idx_b) index arrays — the TUM-tools association step used
    before ATE computation.
    """
    ts_a = np.asarray(ts_a)
    ts_b = np.asarray(ts_b)
    if len(ts_a) == 0 or len(ts_b) == 0:
        return np.array([], dtype=int), np.array([], dtype=int)
    j = np.searchsorted(ts_b, ts_a)
    j = np.clip(j, 1, len(ts_b) - 1)
    left = ts_b[j - 1]
    right = ts_b[j]
    pick_right = np.abs(right - ts_a) < np.abs(ts_a - left)
    jj = np.where(pick_right, j, j - 1)
    dt = np.abs(ts_b[jj] - ts_a)
    keep = dt <= max_dt
    return np.nonzero(keep)[0], jj[keep]
