"""Two-view reconstruction: 8-point essential RANSAC, homography RANSAC,
pose recovery, and the epipolar distance helpers.

Counterpart of ``snakeslam_tpu/ops/twoview.py`` (the reference's
TwoViewReconstruction[EightPoint], HomographyRansac, EssentialMatrix and
EpipolarDistanceSquared).  Hypotheses are solved as one batched
eigen-decomposition; scoring is a dense (H, N) evaluation.  The
hypotheses are drawn from a threefry key as the JAX functions draw them
(``core/prng.py``: the same indices on every device).

The decompositions are library calls (``torch.linalg.eigh`` / ``svd`` /
``det``).  Their float32 results differ between devices: on the card's
batched eigensolver the 8-point normal matrices' smallest eigenvector
rounds otherwise (with the same hypotheses and bit-equal normal matrices,
249 of 256 hypotheses scored otherwise on the full-width mono-VI lane's
first attempt), so monocular initialization runs these functions on the
host (``tracking/mono_init.py``).  Eigenvector and singular-vector signs
are the library's, so ``E`` and ``H`` are defined up to sign.
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.core import lie, prng
from snakeslam_tpu_torch.ops.triangulation import triangulate_homogeneous


def essential_matrix(T12: torch.Tensor) -> torch.Tensor:
    """E from relative pose T12 = T1 @ T2^-1 mapping cam2 -> cam1.

    Convention: x1^T E x2 = 0 for normalized homogeneous coords;
    with T_12 = (R, t): E = [t]x R."""
    return lie.hat(T12[..., :3, 3]) @ T12[..., :3, :3]


def epipolar_distance_squared(E: torch.Tensor, xn1: torch.Tensor,
                              xn2: torch.Tensor) -> torch.Tensor:
    """Symmetric epipolar line-distance squared error, averaged over both
    images (xn1, xn2: (..., 2) normalized coords, x1^T E x2 = 0)."""
    ones = torch.ones(xn1.shape[:-1] + (1,), dtype=xn1.dtype,
                      device=xn1.device)
    h1 = torch.cat([xn1, ones], dim=-1)
    h2 = torch.cat([xn2, ones], dim=-1)
    l1 = h2 @ E.mT      # line in image 1
    l2 = h1 @ E         # line in image 2
    val = torch.sum(h1 * l1, dim=-1)
    d1 = val**2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    d2 = val**2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    return 0.5 * (d1 + d2)


# ---------------------------------------------------------------------------
# 8-point essential + pose recovery
# ---------------------------------------------------------------------------

def _eight_point(xn1: torch.Tensor, xn2: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Essential matrix from >= 8 normalized correspondences, (..., S, 2)
    each (leading dimensions are a batch of samples).

    Solves min |A e| (optionally row-weighted/masked) then projects onto the
    essential manifold (singular values (1, 1, 0))."""
    x1, y1 = xn1[..., 0], xn1[..., 1]
    x2, y2 = xn2[..., 0], xn2[..., 1]
    o = torch.ones_like(x1)
    # x1^T E x2 = 0 rows, e row-major
    A = torch.stack(
        [x1 * x2, x1 * y2, x1, y1 * x2, y1 * y2, y1, x2, y2, o], dim=-1)
    if weights is not None:
        AtA = A.mT @ (A * weights[..., None])
    else:
        AtA = A.mT @ A
    _, V = torch.linalg.eigh(AtA)
    E = V[..., :, 0].reshape(xn1.shape[:-2] + (3, 3))
    U, _, Vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * d) @ Vt


def decompose_essential(E: torch.Tensor) -> torch.Tensor:
    """E -> 4 candidate relative poses T12 (cam2->cam1), |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vt)
    U = U * torch.sign(d)  # make R proper
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack(
        [lie.se3(R1, t), lie.se3(R1, -t), lie.se3(R2, t), lie.se3(R2, -t)])


def essential_ransac(
    xn1: torch.Tensor,
    xn2: torch.Tensor,
    mask: torch.Tensor,
    key,
    n_hypotheses: int = 256,
    threshold: float = 1.5e-5,
):
    """Batched 8-point RANSAC on normalized correspondences.

    threshold is a squared epipolar distance in normalized coords
    (1.5e-5 ~ (1.7px / 450px focal)^2, the usual mono-init gate).
    The hypotheses are drawn from ``key`` over the valid entries of the
    padded ``mask``.

    Returns (E_best, inlier_mask, n_inliers)."""
    sample_idx = prng.sample_without_replacement(key, mask, n_hypotheses, 8)
    Es = _eight_point(xn1[sample_idx], xn2[sample_idx])        # (H, 3, 3)
    d2 = epipolar_distance_squared(Es, xn1[None], xn2[None])
    inl = (d2 < threshold) & mask[None, :]
    best = torch.argmax(torch.sum(inl, dim=1))
    E, inliers = Es[best], inl[best]

    # polish: re-solve the 8-point system on the full inlier set (2 rounds)
    for _ in range(2):
        E = _eight_point(xn1, xn2, weights=inliers.to(xn1.dtype))
        d2 = epipolar_distance_squared(E, xn1, xn2)
        inliers = (d2 < threshold) & mask
    return E, inliers, torch.sum(inliers)


def recover_pose_from_essential(
    E: torch.Tensor,
    xn1: torch.Tensor,
    xn2: torch.Tensor,
    inliers: torch.Tensor,
    min_parallax_cos: float = 0.99998,
):
    """Choose the relative pose among the 4 E-decompositions by cheirality.

    Triangulates all inlier matches under each candidate; picks the pose
    maximizing points in front of both cameras with finite parallax.

    Frame convention here: camera 1 at identity; candidate T2 = T12^-1 is the
    world->cam2 pose.  Returns (T2 (4,4), points (N,3), good_mask (N,))."""
    cands = decompose_essential(E)          # (4, 4, 4) T12: cam2->cam1
    T2s = lie.se3_inverse(cands)            # world(=cam1) -> cam2
    T1 = torch.eye(4, dtype=E.dtype, device=E.device)
    N = xn1.shape[0]
    X = triangulate_homogeneous(
        T1.expand(4, N, 4, 4), T2s[:, None].expand(4, N, 4, 4),
        xn1[None].expand(4, N, 2), xn2[None].expand(4, N, 2))   # (4, N, 3)
    z1 = X[..., 2]
    z2 = lie.transform_points(T2s, X)[..., 2]
    # parallax: rays from the two camera centers
    c2 = lie.translation(cands)             # centre of camera 2 in world
    r1 = X
    r2 = X - c2[:, None, :]
    pcos = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-12)
    good = inliers[None] & (z1 > 0) & (z2 > 0) & (pcos < min_parallax_cos)
    best = torch.argmax(torch.sum(good, dim=1))
    return T2s[best], X[best], good[best]


# ---------------------------------------------------------------------------
# homography RANSAC (planar degeneracy test for mono init)
# ---------------------------------------------------------------------------

def _dlt_homography(xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """H from 4 correspondences (xn1 = H xn2), normalized coords,
    (..., 4, 2) each."""
    x1, y1 = xn1[..., 0], xn1[..., 1]
    x2, y2 = xn2[..., 0], xn2[..., 1]
    o = torch.ones_like(x1)
    z = torch.zeros_like(x1)
    r1 = torch.stack([x2, y2, o, z, z, z, -x1 * x2, -x1 * y2, -x1], dim=-1)
    r2 = torch.stack([z, z, z, x2, y2, o, -y1 * x2, -y1 * y2, -y1], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 8, 9)
    _, V = torch.linalg.eigh(A.mT @ A)
    return V[..., :, 0].reshape(xn1.shape[:-2] + (3, 3))


def homography_ransac(
    xn1: torch.Tensor,
    xn2: torch.Tensor,
    mask: torch.Tensor,
    key,
    n_hypotheses: int = 128,
    threshold: float = 2e-5,
):
    """Batched 4-point homography RANSAC; returns (H, inlier_mask, count).

    Mono initialization is rejected when the scene is planar or the motion
    rotation-only (a high homography-inlier ratio).  The hypotheses are
    drawn from ``key``."""
    sample_idx = prng.sample_without_replacement(key, mask, n_hypotheses, 4)
    Hs = _dlt_homography(xn1[sample_idx], xn2[sample_idx])     # (H, 3, 3)
    h2 = torch.cat([xn2, torch.ones_like(xn2[:, :1])], dim=1)  # (N, 3)
    p = h2[None] @ Hs.mT                                       # (H, N, 3)
    w = torch.where(torch.abs(p[..., 2]) < 1e-12,
                    torch.full_like(p[..., 2], 1e-12), p[..., 2])
    proj = p[..., :2] / w[..., None]
    d2 = torch.sum((proj - xn1[None]) ** 2, dim=-1)
    inl = (d2 < threshold) & mask[None, :]
    scores = torch.sum(inl, dim=1)
    best = torch.argmax(scores)
    return Hs[best], inl[best], scores[best]
