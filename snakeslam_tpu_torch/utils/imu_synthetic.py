"""Synthetic IMU sample generation from a continuous trajectory.

Generates gyro/accelerometer readings consistent with a smooth parametric
camera/body trajectory (central finite differences at the IMU rate), with
configurable biases and noise — the test oracle for the IMU stack.
"""

from __future__ import annotations

import numpy as np

import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.utils.synthetic import lookat_pose_cw

G_WORLD = np.array([0.0, 0.0, -9.81])  # gravity vector (down = -z)


def orbit_pose_wb(t, radius=6.0, height=0.5, ang_vel=0.25,
                  excitation=0.25):
    """Continuous orbit with accelerometer excitation wiggles.

    The fast radial/vertical oscillations (~1-2 m/s^2) make metric scale
    observable for VI initialization — mirroring the hand-held excitation
    at the start of the EuRoC sequences.
    """
    a = ang_vel * t
    r = radius + excitation * np.sin(2.1 * t)
    eye = np.array([
        r * np.sin(a),
        height * np.sin(2.5 * a) + 0.6 * excitation * np.sin(3.3 * t),
        -r * np.cos(a),
    ])
    T_cw = lookat_pose_cw(eye, np.zeros(3))
    T_wc = np.linalg.inv(T_cw)
    return T_wc[:3, :3], T_wc[:3, 3]


def synth_imu(pose_fn, t_start, t_end, rate=200.0, bg=None, ba=None,
              gyro_noise=0.0, acc_noise=0.0, rng=None, g_world=G_WORLD):
    """Sample IMU readings over [t_start, t_end].

    Returns dict(t (S,), omega (S, 3), acc (S, 3), dt (S,)) where sample k
    covers [t_k, t_k + dt_k].
    """
    bg = np.zeros(3) if bg is None else np.asarray(bg)
    ba = np.zeros(3) if ba is None else np.asarray(ba)
    rng = rng or np.random.default_rng(0)
    h = 1.0 / rate
    ts = np.arange(t_start, t_end - 1e-9, h)
    eps = 1e-4
    dRs, acc = [], []
    for t in ts:
        tm = t + 0.5 * h  # midpoint sample
        R0, p0 = pose_fn(tm - eps)
        R1, p1 = pose_fn(tm)
        R2, p2m = pose_fn(tm + eps)
        # angular velocity in body frame: R^T dR/dt ~ hat(w)
        dRs.append(R1.T @ R2)
        # world acceleration via central second difference
        a_w = (p0 - 2 * p1 + p2m) / (eps * eps)
        f = R1.T @ (a_w - g_world)  # specific force in body frame
        acc.append(f)
    # one batched log map over all samples (float64)
    w = lie.so3_log(torch.as_tensor(np.array(dRs).reshape(-1, 3, 3),
                                    dtype=torch.float64)
                    ).numpy() / eps
    # noise is drawn sample by sample, gyro then accelerometer, so a seeded
    # generator gives the same readings as a per-sample loop
    omega = []
    for k in range(len(ts)):
        omega.append(w[k] + bg + rng.normal(scale=gyro_noise, size=3))
        acc[k] = acc[k] + ba + rng.normal(scale=acc_noise, size=3)
    return dict(
        t=ts,
        omega=np.array(omega),
        acc=np.array(acc),
        dt=np.full(len(ts), h),
    )


def true_state(pose_fn, t, eps=1e-4):
    """(R_wb, p, v) of the body at time t (finite-difference velocity)."""
    R, p = pose_fn(t)
    _, p0 = pose_fn(t - eps)
    _, p1 = pose_fn(t + eps)
    v = (p1 - p0) / (2 * eps)
    return R, p, v
