"""Batched two-view triangulation (inhomogeneous DLT).

Counterpart of ``snakeslam_tpu/ops/triangulation.py``: each candidate match
triangulates independently through the closed-form 3x3 cofactor solve of
the DLT normal equations (elementwise arithmetic, no batched eigen solve).
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.core import lie


def triangulate_homogeneous(T1: torch.Tensor, T2: torch.Tensor,
                            xn1: torch.Tensor,
                            xn2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation in normalized camera coordinates.

    Args:
      T1, T2: (..., 4, 4) world->camera poses.
      xn1, xn2: (..., 2) normalized image coords in camera 1 / 2.
    Returns:
      (..., 3) world points (may be behind either camera; callers gate).
    """
    P1 = T1[..., :3, :]
    P2 = T2[..., :3, :]
    rows = torch.stack(
        [
            xn1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            xn1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            xn2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            xn2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )  # (..., 4, 4)
    # w = 1 fixed (finite points; far points come out large and the
    # callers' chi2 / parallax / scale gates handle them): solve the 3x3
    # normal equations min ||A3 x + b|| by cofactors.  Forming A3^T A3
    # squares the rows' condition number (~1/parallax): at the ~1 degree
    # parallax of neighbouring keyframes an f32 solve is good to ~2e-4
    # relative (centimetres at 15 m, and any two f32 evaluation orders
    # differ by that much), so the normal equations and their solve run
    # in float64 (a few hundred flops per row, cheap on the card) and
    # leave only the rows' own f32 rounding (~1e-6 relative)
    A3 = rows[..., :3].double()                 # (..., 4, 3)
    b = rows[..., 3].double()                   # (..., 4)
    N = A3.mT @ A3                              # (..., 3, 3)
    g = -torch.einsum("...ki,...k->...i", A3, b)
    n00, n01, n02 = N[..., 0, 0], N[..., 0, 1], N[..., 0, 2]
    n11, n12, n22 = N[..., 1, 1], N[..., 1, 2], N[..., 2, 2]
    c00 = n11 * n22 - n12 * n12
    c01 = n02 * n12 - n01 * n22
    c02 = n01 * n12 - n02 * n11
    c11 = n00 * n22 - n02 * n02
    c12 = n01 * n02 - n00 * n12
    c22 = n00 * n11 - n01 * n01
    det = n00 * c00 + n01 * c01 + n02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20,
                                torch.full_like(det, 1e-20), det)
    x = (c00 * g[..., 0] + c01 * g[..., 1] + c02 * g[..., 2]) * inv_det
    y = (c01 * g[..., 0] + c11 * g[..., 1] + c12 * g[..., 2]) * inv_det
    z = (c02 * g[..., 0] + c12 * g[..., 1] + c22 * g[..., 2]) * inv_det
    return torch.stack([x, y, z], dim=-1).to(rows.dtype)


def depths_in_cameras(T1, T2, Xw):
    """Depths of world points in both cameras (for cheirality gates)."""
    z1 = lie.transform_points(T1, Xw)[..., 2]
    z2 = lie.transform_points(T2, Xw)[..., 2]
    return z1, z2


def reprojection_error_normalized(T, Xw, xn):
    """Squared reprojection error in normalized coords, and the depth."""
    pc = lie.transform_points(T, Xw)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    proj = pc[..., :2] / zs[..., None]
    return torch.sum((proj - xn) ** 2, dim=-1), z


def parallax_cos(T1, T2, Xw):
    """Cosine of the ray parallax angle at each point."""
    c1 = lie.translation(lie.se3_inverse(T1))
    c2 = lie.translation(lie.se3_inverse(T2))
    r1 = Xw - c1[..., None, :] if Xw.ndim > c1.ndim else Xw - c1
    r2 = Xw - c2[..., None, :] if Xw.ndim > c2.ndim else Xw - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
