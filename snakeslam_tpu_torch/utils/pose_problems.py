"""Seeded robust pose problems for checking the pose kernels.

The problem of ``tests/test_pose_pallas.py``: N world points in front of a
pinhole camera, a ground-truth pose with a small rotation and translation,
0.3 px noise, 60 gross outliers, 40 masked slots, and (stereo) right-image
coordinates on two thirds of the points; the initial pose is a perturbed
ground truth.

Edge cases beside it, shared by the CPU parity tests and the card tests:
``n_behind`` points moved behind the camera (negative depth: the depth
gate must drop them), and ``all_masked_problem`` (no feature counts: the
normal equations are the damping alone, so the pose stays T_init up to the
final Gram-Schmidt).
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole

CAM = (450.0, 451.0, 370.0, 240.0)
BF = 48.0


def pose_problem(seed: int, n: int, stereo: bool, device, n_outliers=60,
                 n_behind=0):
    """Returns (args, T_gt): ``args`` = (T_init, points, uv, right, weight,
    mask, cam, bf) float32 / bool tensors on ``device`` in
    ``pose_refine_fused``'s order; ``T_gt`` a float64 numpy (4, 4).
    ``n_behind`` points (drawn after every other draw) move to the far
    side of the camera plane, keeping their observations."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * np.array([4, 3, 5]) + [0, 0, 12]
    xi = rng.normal(size=6) * np.array([0.1, 0.1, 0.1, 0.02, 0.02, 0.02])
    T_gt = lie.se3_exp(torch.from_numpy(xi)).numpy()
    pc = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    fx, fy, cx, cy = CAM
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    uv = np.stack([u, v], 1) + rng.normal(size=(n, 2)) * 0.3
    right = (u - BF / pc[:, 2]) + rng.normal(size=n) * 0.3
    if not stereo:
        right = np.full(n, -1.0)
    else:
        right[rng.choice(n, n // 3, replace=False)] = -1.0
    out_idx = rng.choice(n, n_outliers, replace=False)
    uv[out_idx] += rng.normal(size=(n_outliers, 2)) * 40.0
    mask = np.ones(n, dtype=bool)
    mask[rng.choice(n, 40, replace=False)] = False
    weight = rng.uniform(0.5, 1.0, n)
    dxi = rng.normal(size=6) * np.array([0.02, 0.02, 0.02, 5e-3, 5e-3, 5e-3])
    T0 = lie.se3_exp(torch.from_numpy(dxi)).numpy() @ T_gt
    if n_behind:
        idx = rng.choice(n, n_behind, replace=False)
        behind = pc[idx].copy()
        behind[:, 2] = -np.abs(behind[:, 2])
        pts[idx] = (behind - T_gt[:3, 3]) @ T_gt[:3, :3]

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    args = (f32(T0), f32(pts), f32(uv), f32(right), f32(weight),
            torch.tensor(mask, device=device),
            Pinhole.create(*CAM, device=device), f32(BF))
    return args, T_gt


def all_masked_problem(seed: int, n: int, stereo: bool, device):
    """``pose_problem`` with every feature masked out."""
    args, T_gt = pose_problem(seed, n, stereo, device)
    return (*args[:5], torch.zeros_like(args[5]), *args[6:]), T_gt


EDGE_CASES = {
    "all_masked": all_masked_problem,
    "behind_camera": lambda seed, n, stereo, device: pose_problem(
        seed, n, stereo, device, n_behind=n // 4),
}
