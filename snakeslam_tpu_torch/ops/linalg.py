"""Small-matrix linear algebra on batched tensors.

Counterpart of ``snakeslam_tpu/ops/linalg.py``.  Every normal-equation
matrix here is symmetric positive (semi-)definite after damping; the
closed-form adjugate (3x3) and block Schur (6x6) solves are plain
elementwise arithmetic, so they need no solver library call per frame.
"""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) matrices via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ x = (..., 3) via the closed-form inverse."""
    return (inv3x3(A) @ b[..., None])[..., 0]


def solve6x6_psd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 6, 6) PSD solve via the 3x3 block Schur complement."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    A_inv = inv3x3(A)
    BtAi = B.transpose(-1, -2) @ A_inv
    S = D - BtAi @ B
    x2 = (inv3x3(S) @ (b2 - (BtAi @ b1[..., None])[..., 0])[..., None])[..., 0]
    x1 = (A_inv @ (b1 - (B @ x2[..., None])[..., 0])[..., None])[..., 0]
    return torch.cat([x1, x2], dim=-1)


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A via Cholesky.

    b may be (..., N) or (..., N, K); A is (..., N, N)."""
    L = torch.linalg.cholesky(A)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    x = torch.cholesky_solve(b, L)
    return x[..., 0] if vec else x
