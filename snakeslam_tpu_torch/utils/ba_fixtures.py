"""Synthetic BA problem generator (fixtures for the tests, the multi-device
dry run and the chip smoke test).

Counterpart of ``snakeslam_tpu/utils/ba_fixtures.py``: the same seeded
numpy draws in the same order, so both packages build the same problem
from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.ops import ba as BA


def _se3_exp_np(xi) -> np.ndarray:
    return lie.se3_exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()


def make_synthetic_ba_problem(C=8, P=256, M=8, noise_px=0.2, pose_noise=0.01,
                              point_noise=0.05, n_fixed=2, seed=0,
                              fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                              device="cpu", dtype=torch.float32):
    """Cameras on an arc looking at a cloud of P points 10-18 m away, each
    point observed (mono) by up to M of the C cameras with pixel noise;
    the first ``n_fixed`` cameras are fixed at the truth, the others and
    the points perturbed.  Returns (BAProblem on ``device`` with float
    fields of ``dtype``, true camera poses (C, 4, 4), true points (P, 3))
    as float64 numpy for the last two."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(P, 3))
    pts[:, 2] += 14.0
    cams_true = np.stack([
        _se3_exp_np([0.4 * c, 0.02 * c, 0.0, 0.0, 0.04 * c, 0.0])
        for c in range(C)
    ])
    obs_cam = np.full((P, M), -1, dtype=np.int32)
    obs_uv = np.zeros((P, M, 2))
    obs_right = np.full((P, M), -1.0)
    obs_valid = np.zeros((P, M), dtype=bool)
    for p in range(P):
        cs = rng.choice(C, size=min(M, C), replace=False)
        for k, c in enumerate(cs):
            T = cams_true[c]
            pc = T[:3, :3] @ pts[p] + T[:3, 3]
            if pc[2] < 0.5:
                continue
            obs_cam[p, k] = c
            obs_uv[p, k] = (
                fx * pc[0] / pc[2] + cx + rng.normal(scale=noise_px),
                fy * pc[1] / pc[2] + cy + rng.normal(scale=noise_px),
            )
            obs_valid[p, k] = True
    cam_noisy = cams_true.copy()
    for c in range(n_fixed, C):
        xi = rng.normal(size=6) * pose_noise
        cam_noisy[c] = _se3_exp_np(xi) @ cams_true[c]
    fixed = np.zeros(C, dtype=bool)
    fixed[:n_fixed] = True
    points = pts + rng.normal(scale=point_noise, size=pts.shape)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def t(a):
        return torch.as_tensor(a, device=device)

    problem = BA.BAProblem(
        cam_pose=f(cam_noisy),
        cam_fixed=t(fixed),
        cam_valid=torch.ones(C, dtype=torch.bool, device=device),
        points=f(points),
        point_valid=torch.ones(P, dtype=torch.bool, device=device),
        obs_cam=t(obs_cam),
        obs_uv=f(obs_uv),
        obs_right=f(obs_right),
        obs_weight=torch.ones((P, M), dtype=dtype, device=device),
        obs_valid=t(obs_valid),
        **BA.empty_rpc(device, dtype),
    )
    return problem, cams_true, pts
