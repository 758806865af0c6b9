"""Small-matrix linear algebra on batched tensors.

Counterpart of ``snakeslam_tpu/ops/linalg.py``.  Every normal-equation
matrix here is symmetric positive (semi-)definite after damping; the
closed-form adjugate (3x3) and block Schur (6x6) solves are plain
elementwise arithmetic, so they need no solver library call per frame.
"""

from __future__ import annotations

import threading

import torch

# held while ``solve_lu`` switches the process-wide preferred library
_library_lock = threading.Lock()


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


JACOBI_SWEEPS = 8


def svd3x3(A: torch.Tensor):
    """SVD of (..., 3, 3) matrices by one-sided (Hestenes) Jacobi: fixed
    sweeps of plane rotations orthogonalize the columns of A V, which then
    are U diag(sigma).  Plain elementwise arithmetic with fixed trip
    counts: unlike a solver library call, nothing checks a result on the
    host.  Eight sweeps reach float64 precision on a 3x3 (convergence is
    quadratic).

    Returns (U, sigma, Vt) with sigma in descending order.  U's third
    column is u1 x u2, so det(U) = +1, and sigma[..., 2] = u3 . (A v3) is
    signed: U diag(sigma) Vt = A, and a rank-deficient A (a minimal
    three-point sample) still gets a right-handed U."""
    AV = A.clone()
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    tiny = torch.finfo(A.dtype).tiny
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = AV[..., :, p], AV[..., :, q]
            alpha = torch.sum(ap * ap, dim=-1)
            beta = torch.sum(aq * aq, dim=-1)
            gamma = torch.sum(ap * aq, dim=-1)
            off = torch.abs(gamma) > tiny
            zeta = (beta - alpha) / (2.0 * torch.where(
                off, gamma, torch.ones_like(gamma)))
            sgn = torch.where(zeta >= 0, 1.0, -1.0).to(A.dtype)
            t = sgn / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(off, t, torch.zeros_like(t))
            c = torch.rsqrt(1.0 + t * t)
            s = c * t
            for M in (AV, V):
                mp, mq = M[..., :, p].clone(), M[..., :, q]
                M[..., :, p] = c[..., None] * mp - s[..., None] * mq
                M[..., :, q] = s[..., None] * mp + c[..., None] * mq
    sig = torch.linalg.norm(AV, dim=-2)                       # (..., 3)
    order = torch.argsort(-sig, dim=-1)
    col = order[..., None, :].expand(A.shape)
    AV = torch.gather(AV, -1, col)
    V = torch.gather(V, -1, col)
    sig = torch.gather(sig, -1, order)
    u1 = AV[..., :, 0] / torch.clamp(sig[..., 0:1], min=tiny)
    u2 = AV[..., :, 1] / torch.clamp(sig[..., 1:2], min=tiny)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    s3 = torch.sum(u3 * AV[..., :, 2], dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)
    return U, torch.stack([sig[..., 0], sig[..., 1], s3], dim=-1), V.mT


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A via Cholesky.

    b may be (..., N) or (..., N, K); A is (..., N, N).  A matrix that is
    not positive-definite yields NaN, as the JAX function does, instead of
    raising: ``cholesky_ex`` leaves its error flag on the device, so the
    solve never waits on the host, and callers (the LBA commit) drop the
    non-finite result."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vec else x


def solve_lu(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b by pivoted LU, without a host sync: ``solve_ex``
    leaves its error flag on the device (a singular A gives non-finite
    values where ``torch.linalg.solve`` raises), so the solve can be
    captured into a CUDA graph.  On the card the preferred linear-algebra
    library is cuSOLVER for this call only: for some sizes PyTorch's
    heuristic picks MAGMA, whose calls cannot be captured.  The setting is
    process-wide, so a lock holds it from the switch to the restore: two
    threads' calls take turns and neither restores the other's setting
    mid-call (linear algebra on another thread meanwhile may also take
    cuSOLVER).  On the CPU this is ``torch.linalg.solve``'s own LAPACK
    path, bit for bit."""
    if A.device.type != "cuda":
        return torch.linalg.solve_ex(A, b)[0]
    with _library_lock:
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            return torch.linalg.solve_ex(A, b)[0]
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)
