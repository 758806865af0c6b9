"""Two-view geometry: the epipolar helpers of pair triangulation.

Counterpart of ``snakeslam_tpu/ops/twoview.py`` for the keyframe back-end:
``essential_matrix`` and ``epipolar_distance_squared``.  The 8-point
essential and homography RANSACs and pose recovery serve monocular
initialization and arrive with it (ROADMAP.md queue A, step 12).
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.core import lie


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


def _unported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"twoview.{name}: monocular two-view initialization is ported "
            "with mono initialization (ROADMAP.md queue A, step 12)")
    fn.__name__ = name
    return fn


essential_ransac = _unported("essential_ransac")
homography_ransac = _unported("homography_ransac")
recover_pose_from_essential = _unported("recover_pose_from_essential")
