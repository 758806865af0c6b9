"""Robust pose-only Gauss-Newton and RANSAC PnP on tensors.

Counterpart of ``snakeslam_tpu/ops/pose_solver.py`` (saiga's
RobustPoseOptimization / P3PRansac in the reference).  All residuals of a
frame are one batched tensor; the 6x6 normal equations are einsum
reductions solved in closed form.

Conventions:
  - Poses are world->camera SE3 (4, 4) tensors.
  - The update is left-multiplicative: T <- exp(delta) @ T.
  - ``weight`` per observation = 1/scale(octave).
  - Stereo observations carry a right-image x (> 0); mono ones have
    right < 0 and use the 2D residual only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops.linalg import solve6x6_psd


class PoseObs(NamedTuple):
    """Fixed-size observation block for pose-only optimization (M slots)."""

    points: torch.Tensor   # (M, 3) world points
    uv: torch.Tensor       # (M, 2) measured pixels
    right: torch.Tensor    # (M,) measured right-image x; < 0 => mono
    weight: torch.Tensor   # (M,) = 1/scale(octave)
    mask: torch.Tensor     # (M,) bool valid slot


def _residuals_jacobians(T, obs: PoseObs, cam: Pinhole, bf):
    """Per-observation residuals (M, 3) and Jacobians (M, 3, 6); the third
    row is the stereo term, zeroed for mono observations."""
    pc = lie.transform_points(T, obs.points)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_ok = z > 1e-4
    zs = torch.where(z_ok, z, torch.ones_like(z))
    iz = 1.0 / zs
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - bf * iz

    has_stereo = obs.right > 0
    r = torch.stack(
        [u - obs.uv[:, 0], v - obs.uv[:, 1],
         torch.where(has_stereo, ur - obs.right, torch.zeros_like(ur))],
        dim=1,
    )
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    # d(pc)/d(delta) with left perturbation: [I | -hat(pc)]  (M, 3, 6);
    # the hat block uses the raw z, not the clamped one
    dpc = torch.stack(
        [
            torch.stack([ones, zeros, zeros, zeros, z, -y], dim=1),
            torch.stack([zeros, ones, zeros, -z, zeros, x], dim=1),
            torch.stack([zeros, zeros, ones, y, -x, zeros], dim=1),
        ],
        dim=1,
    )
    fx = cam.fx.expand_as(x)
    fy = cam.fy.expand_as(x)
    Jp = torch.stack(
        [
            torch.stack([fx * iz, zeros, -fx * x * iz2], dim=1),
            torch.stack([zeros, fy * iz, -fy * y * iz2], dim=1),
            torch.stack([fx * iz, zeros, (-fx * x + bf) * iz2], dim=1),
        ],
        dim=1,
    )
    J = Jp @ dpc
    row_keep = torch.ones(3, dtype=J.dtype, device=J.device)
    row_keep[2] = 0.0
    J = torch.where(has_stereo[:, None, None], J, J * row_keep[None, :, None])
    valid = obs.mask & z_ok
    return r, J, valid, has_stereo


def _chi2(r, obs: PoseObs, has_stereo):
    """Scale-weighted squared error |w * r|^2 (stereo 3 rows, mono 2)."""
    w2 = obs.weight ** 2
    e2 = torch.where(has_stereo, torch.sum(r * r, dim=1),
                     r[:, 0] ** 2 + r[:, 1] ** 2)
    return w2 * e2


def robust_pose_refine(
    T_init: torch.Tensor,
    obs: PoseObs,
    cam: Pinhole,
    bf: torch.Tensor,
    chi2_mono: float = 2.1 ** 2,
    chi2_stereo: float = 2.3 ** 2,
    outer_iters: int = 4,
    inner_iters: int = 3,
    prior_T: torch.Tensor | None = None,
    prior_weight_rotation: torch.Tensor | float = 0.0,
    prior_weight_translation: torch.Tensor | float = 0.0,
    damping: float = 1e-5,
):
    """Robust pose-only GN with interleaved outlier classification:
    ``outer_iters`` rounds of (``inner_iters`` Huber-weighted GN steps on the
    current inliers) -> (chi2 re-classification).  The optional motion
    prior adds the 6-dof residual log(T @ prior_T^-1) with split
    rotation/translation weights.

    Returns (T_refined, inlier_mask (M,), n_inliers)."""
    dt, dev = T_init.dtype, T_init.device
    use_prior = prior_T is not None
    if use_prior:
        prior_T_inv = lie.se3_inverse(prior_T)
        w_rot = torch.as_tensor(prior_weight_rotation, dtype=dt, device=dev)
        w_trans = torch.as_tensor(prior_weight_translation, dtype=dt,
                                  device=dev)
        w_p = torch.cat([w_trans.expand(3), w_rot.expand(3)])
    delta_huber_mono = float(np.sqrt(chi2_mono))
    delta_huber_stereo = float(np.sqrt(chi2_stereo))
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def gn_step(T, inlier):
        r, J, valid, has_stereo = _residuals_jacobians(T, obs, cam, bf)
        w = obs.weight
        e = torch.sqrt(_chi2(r, obs, has_stereo) + 1e-12)
        delta_h = torch.where(has_stereo, delta_huber_stereo, delta_huber_mono)
        huber = torch.clamp(delta_h / e, max=1.0)
        w_total = torch.where(valid & inlier, w * w * huber,
                              torch.zeros_like(w))
        H = torch.einsum("mki,m,mkj->ij", J, w_total, J)
        b = torch.einsum("mki,m,mk->i", J, w_total, r)
        if use_prior:
            r_p = lie.se3_log(T @ prior_T_inv)
            H = H + torch.diag(w_p)
            b = b + w_p * r_p
        H = H + damping * eye6
        delta = solve6x6_psd(H, b)
        return lie.orthonormalize(lie.se3_exp(-delta) @ T)

    T = lie.orthonormalize(T_init)
    inlier = obs.mask
    for _ in range(outer_iters):
        for _ in range(inner_iters):
            T = gn_step(T, inlier)
        r, J, valid, has_stereo = _residuals_jacobians(T, obs, cam, bf)
        chi2 = _chi2(r, obs, has_stereo)
        th = torch.where(has_stereo, chi2_stereo, chi2_mono)
        inlier = valid & (chi2 <= th)
    return T, inlier, torch.sum(inlier)


# ---------------------------------------------------------------------------
# RANSAC PnP (DLT-6 hypotheses + GN polish)
# ---------------------------------------------------------------------------

def _dlt_pnp(points: torch.Tensor, bearings: torch.Tensor) -> torch.Tensor:
    """Batched direct linear transform pose from 6-point samples.

    points (H, S, 3) world, bearings (H, S, 2) normalized coords ->
    (H, 4, 4) world->camera poses."""
    Hn, S = points.shape[:2]
    X = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    zeros = torch.zeros_like(X)
    u = bearings[..., 0:1]
    v = bearings[..., 1:2]
    rows_u = torch.cat([X, zeros, -u * X], dim=-1)
    rows_v = torch.cat([zeros, X, -v * X], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)           # (H, 2S, 12)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    p = Vt[:, -1].reshape(Hn, 3, 4)
    M = p[:, :, :3]
    Um, Dm, Vmt = torch.linalg.svd(M)
    scale = Dm.mean(dim=-1)
    R = Um @ Vmt
    detR = torch.linalg.det(R)
    R = R * detR[:, None, None]
    t = p[:, :, 3] / scale[:, None] * detR[:, None]
    pc_z = (points @ R.transpose(-1, -2) + t[:, None, :])[..., 2]
    flip = (pc_z > 0).sum(dim=-1) < (S / 2)
    R = torch.where(flip[:, None, None], -R, R)
    t = torch.where(flip[:, None], -t, t)
    return lie.se3(R, t)


def pnp_ransac(
    points: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    cam: Pinhole,
    generator: torch.Generator,
    n_hypotheses: int = 256,
    sample_size: int = 6,
    inlier_threshold_px: float = 4.0,
    min_depth: float = 1e-3,
):
    """Batched RANSAC PnP: 6-point DLT hypotheses drawn without
    replacement from the valid set (Gumbel top-k), scored against all
    points.  ``generator`` lives on the tensors' device.

    Returns (best_T, inlier_mask, n_inliers)."""
    M = points.shape[0]
    bearings = cam.unproject_pixels(uv)
    logits = torch.where(mask, 0.0, float("-inf")).to(points.dtype)
    uni = torch.rand((n_hypotheses, M), generator=generator,
                     device=points.device, dtype=points.dtype)
    uni = uni * (1.0 - 1e-9) + 1e-9
    gumbel = -torch.log(-torch.log(uni))
    _, sample_idx = torch.topk(logits[None, :] + gumbel, sample_size, dim=-1)
    Ts = _dlt_pnp(points[sample_idx], bearings[sample_idx])   # (H, 4, 4)

    pc = torch.einsum("hij,mj->hmi", Ts[:, :3, :3], points) \
        + Ts[:, None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z > min_depth, z, torch.ones_like(z))
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (z > min_depth) & (err2 < inlier_threshold_px ** 2) & mask[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    return Ts[best], inl[best], scores[best]


def pnp_refine_np(obs_pts, obs_uv, cam: Pinhole, bf, generator,
                  n_hypotheses: int = 256):
    """Host front door: PnP RANSAC + robust refine of n >= 6 host
    correspondences on the camera's device.

    Returns (n0, T (4, 4) tensor, inlier (n,) bool np, n_inl)."""
    dev = cam.fx.device
    p = len(obs_pts)
    pts_t = torch.from_numpy(np.asarray(obs_pts, dtype=np.float32)).to(dev)
    uv_t = torch.from_numpy(np.asarray(obs_uv, dtype=np.float32)).to(dev)
    mask = torch.ones(p, dtype=torch.bool, device=dev)
    T0, _, n0 = pnp_ransac(pts_t, uv_t, mask, cam, generator,
                           n_hypotheses=n_hypotheses)
    obs = PoseObs(
        points=pts_t, uv=uv_t,
        right=torch.full((p,), -1.0, dtype=torch.float32, device=dev),
        weight=torch.ones(p, dtype=torch.float32, device=dev), mask=mask,
    )
    T, inlier, n_inl = robust_pose_refine(T0, obs, cam, bf)
    return int(n0), T, inlier.cpu().numpy(), int(n_inl)
