"""Seeded keyframe back-end problems for checking the back-end ops on a
device: a local-BA-shaped problem for ``ops/ba.solve_ba`` and a keyframe
neighbourhood for ``ops/triangulate_pairs.triangulate_pairs_batch``.

Both are made with numpy from a seed, so the same problem can be put on
the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.ops import ba as BA
from snakeslam_tpu_torch.ops.depth_grid import build_depth_grid
from snakeslam_tpu_torch.ops.matching import FrameFeatures

CAM = (458.654, 457.296, 367.215, 248.375)   # EuRoC-like, 752 x 480
BF = 458.654 * 0.11
WIDTH, HEIGHT = 752, 480


def _se3(xi) -> np.ndarray:
    return lie.se3_exp(torch.from_numpy(np.asarray(xi, np.float64))).numpy()


def ba_problem(C: int, P: int, M: int, seed: int, device,
               noise_px: float = 0.3, n_fixed: int = 2):
    """A stereo BA problem with C camera slots, P points and M observation
    slots per point: cameras 0.1 m apart on a gently turning arc, points in
    an 8 m box 14 m ahead, each seen by M random cameras with ``noise_px``
    pixel noise; the free cameras start 1 cm / 10 mrad off and the points
    5 cm off.  Returns (BAProblem on ``device``, cam, bf)."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAM
    pts = rng.uniform(-4, 4, size=(P, 3)) + np.array([0.0, 0.0, 14.0])
    cams = np.stack([_se3([0.1 * c, 0.005 * c, 0.0, 0.0, 0.01 * c, 0.0])
                     for c in range(C)])
    obs_cam = np.full((P, M), -1, dtype=np.int32)
    obs_uv = np.zeros((P, M, 2))
    obs_right = np.full((P, M), -1.0)
    for p in range(P):
        cs = rng.choice(C, size=min(M, C), replace=False)
        T = cams[cs]
        pc = np.einsum("kij,j->ki", T[:, :3, :3], pts[p]) + T[:, :3, 3]
        u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(scale=noise_px,
                                                       size=len(cs))
        v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(scale=noise_px,
                                                       size=len(cs))
        obs_cam[p, :len(cs)] = cs
        obs_uv[p, :len(cs)] = np.stack([u, v], 1)
        obs_right[p, :len(cs)] = u - BF / pc[:, 2] + rng.normal(
            scale=noise_px, size=len(cs))
    cam_noisy = cams.copy()
    for c in range(n_fixed, C):
        cam_noisy[c] = _se3(rng.normal(size=6) * 0.01) @ cams[c]
    fixed = np.zeros(C, dtype=bool)
    fixed[:n_fixed] = True
    R = C
    problem = BA.problem_to_device(
        cam_noisy, fixed, np.ones(C, bool),
        pts + rng.normal(scale=0.05, size=pts.shape), np.ones(P, bool),
        obs_cam, obs_uv, obs_right, np.ones((P, M)), obs_cam >= 0,
        np.zeros(R, np.int32), np.zeros(R, np.int32),
        np.tile(np.eye(4), (R, 1, 1)), np.zeros((R, 6)), np.zeros(R, bool),
        device)
    return (problem, Pinhole.create(*CAM, device=device),
            torch.tensor(BF, dtype=torch.float32, device=device))


def pair_problem(n_slots: int, n_pairs: int, seed: int, device):
    """Keyframe a and ``n_pairs`` neighbours 0.3 m apart on an arc around a
    point cloud 6-12 m ahead; each keyframe has ``n_slots`` features: the
    projections of its visible points with 0.4 px noise and 3% descriptor
    bits flipped, 10% clutter, octaves 0-2, stereo on two thirds; a third
    of a's features and a fifth of each neighbour's are taken (not free);
    a depth grid built from a's stereo depths.  Returns the keyword
    arguments of ``triangulate_pairs_batch`` with tensors on ``device``."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAM
    n_pts = int(n_slots * 0.9)
    X = rng.uniform(-4, 4, (n_pts, 3)) * np.array([1.0, 0.7, 0.75]) \
        + np.array([1.5, 0.0, 9.0])
    desc = rng.integers(0, 2, size=(n_pts, 256))
    poses = np.stack([_se3([-0.3 * k, 0.0, 0.0, 0.0, 0.01 * k, 0.0])
                      for k in range(n_pairs + 1)])
    feats, z_a = [], None
    for k in range(n_pairs + 1):
        order = rng.permutation(n_pts)
        pc = X[order] @ poses[k, :3, :3].T + poses[k, :3, 3]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], 1)
        uv += rng.normal(scale=0.4, size=uv.shape)
        bits = desc[order] ^ (rng.random((n_pts, 256)) < 0.03)
        n_clutter = n_slots - n_pts
        uv = np.concatenate([uv, rng.uniform((0, 0), (WIDTH, HEIGHT),
                                             (n_clutter, 2))])
        bits = np.concatenate([bits, rng.integers(0, 2, (n_clutter, 256))])
        z = np.concatenate([pc[:, 2], rng.uniform(6, 12, n_clutter)])
        right = np.where(rng.random(n_slots) < 0.66,
                         uv[:, 0] - BF / z + rng.normal(scale=0.3,
                                                        size=n_slots), -1.0)
        valid = (uv[:, 0] >= 0) & (uv[:, 0] < WIDTH) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < HEIGHT)
        feats.append((uv, right, rng.integers(0, 3, n_slots),
                      np.zeros(n_slots), bits, valid))
        if k == 0:
            z_a = np.where(right > 0, z, -1.0)

    def ff(rows):
        uv, right, octave, angle, bits, valid = rows
        return FrameFeatures(
            uv=torch.tensor(uv, dtype=torch.float32, device=device),
            right=torch.tensor(right, dtype=torch.float32, device=device),
            octave=torch.tensor(octave, dtype=torch.int32, device=device),
            angle=torch.tensor(angle, dtype=torch.float32, device=device),
            desc_bits=torch.tensor(bits, dtype=torch.int8, device=device),
            valid=torch.tensor(valid, device=device))

    fb = [ff(f) for f in feats[1:]]
    pyr = ScalePyramid.create(4, 1.2)
    grid = build_depth_grid(feats[0][0], z_a, WIDTH, HEIGHT)
    return dict(
        feats_a=ff(feats[0]),
        feats_b=FrameFeatures(*(torch.stack([getattr(f, k) for f in fb])
                                for k in FrameFeatures._fields)),
        free_a=torch.tensor(rng.random(n_slots) > 0.33, device=device),
        free_b=torch.tensor(rng.random((n_pairs, n_slots)) > 0.2,
                            device=device),
        T_a=torch.tensor(poses[0], dtype=torch.float32, device=device),
        T_b=torch.tensor(poses[1:], dtype=torch.float32, device=device),
        cam=Pinhole.create(*CAM, device=device),
        bf=torch.tensor(BF, dtype=torch.float32, device=device),
        scales=torch.tensor(pyr.scales, device=device),
        inv_sigma2=torch.tensor(pyr.inv_sigma2, device=device),
        grid_a=torch.tensor(grid, device=device),
        bounds_wh=(float(WIDTH), float(HEIGHT)),
        th_depth=25.0,
    )
