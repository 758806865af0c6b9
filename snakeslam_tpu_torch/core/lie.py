"""SO3 / SE3 / Sim3 Lie-group operations on batched tensors.

Counterpart of ``snakeslam_tpu/core/lie.py``.  Poses are homogeneous
``(..., 4, 4)`` float tensors (world->camera), so composition is a matmul;
a Sim3 is the same 4x4 with the scaled rotation ``s*R`` in the upper-left
block.  Every function accepts arbitrary leading batch dimensions and keeps
the formulas, Taylor cutoffs and branch selection of the JAX version,
written with ``torch.where`` so nothing syncs the host.
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.ops.linalg import solve3x3

_EPS = 1e-8


def safe_norm(v: torch.Tensor) -> torch.Tensor:
    """L2 norm along the last axis, exactly 0 at v == 0."""
    n2 = torch.sum(v * v, dim=-1)
    n = torch.sqrt(torch.where(n2 == 0.0, torch.ones_like(n2), n2))
    return torch.where(n2 == 0.0, torch.zeros_like(n), n)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = torch.abs(x) < 0.05
    xs = torch.where(small, torch.ones_like(x), x)
    taylor = 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0)
    return torch.where(small, taylor, torch.sin(xs) / xs)


def _one_minus_cos_over_x2(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = torch.abs(x) < 0.1
    xs = torch.where(small, torch.ones_like(x), x)
    taylor = 0.5 - x2 / 24.0 * (1.0 - x2 / 30.0)
    return torch.where(small, taylor, (1.0 - torch.cos(xs)) / (xs * xs))


def _x_minus_sin_over_x3(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = torch.abs(x) < 0.2
    xs = torch.where(small, torch.ones_like(x), x)
    taylor = (1.0 / 6.0) * (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0))
    return torch.where(small, taylor, (xs - torch.sin(xs)) / (xs ** 3))


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta = safe_norm(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _one_minus_cos_over_x2(theta)[..., None, None]
    return _eye3_like(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_axis_angle(rotmat_to_quat(R))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z), w >= 0.

    Shepperd's branchless method: all four candidate constructions, the
    numerically best selected per element."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _s(q2):
        return torch.sqrt(torch.clamp(q2, min=_EPS)) * 2.0

    s = _s(qw2)
    c0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s], dim=-1)
    s = _s(qx2)
    c1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s], dim=-1)
    s = _s(qy2)
    c2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s], dim=-1)
    s = _s(qz2)
    c3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    scores = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(
        cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, x, y, z) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w >= 0) -> axis-angle (..., 3)."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = safe_norm(v)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-7
    scale = torch.where(small, 2.0 + theta * theta / 12.0,
                        theta / torch.where(small, torch.ones_like(vn), vn))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# SE3 — (..., 4, 4) homogeneous matrices
# ---------------------------------------------------------------------------

def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    # the [0, 0, 0, 1] row from a device-side eye: writing a Python scalar
    # into a CUDA tensor can copy it from the host, which syncs
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3(Rt, -(Rt @ t[..., None])[..., 0])


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 6) = (upsilon[3], omega[3]) -> (..., 4, 4) (Sophus
    ordering: translation part first)."""
    v = xi[..., :3]
    w = xi[..., 3:]
    theta = safe_norm(w)
    W = hat(w)
    W2 = W @ W
    R = so3_exp(w)
    b = _one_minus_cos_over_x2(theta)[..., None, None]
    c = _x_minus_sin_over_x3(theta)[..., None, None]
    V = _eye3_like(W) + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    return se3(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> tangent (..., 6) = (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta = safe_norm(w)
    W = hat(w)
    W2 = W @ W
    A = _sinc(theta)
    B = _one_minus_cos_over_x2(theta)
    small = theta < 0.1
    th2 = torch.where(small, torch.ones_like(theta), theta * theta)
    t2 = theta * theta
    taylor = (1.0 / 12.0) * (1.0 + t2 / 60.0)
    coef = torch.where(small, taylor, (1.0 - A / (2.0 * B)) / th2)
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (quaternion roundtrip);
    solvers call this after every pose update so f32 composition defects
    cannot grow through se3_inverse."""
    R = quat_to_rotmat(rotmat_to_quat(T[..., :3, :3]))
    return se3(R, T[..., :3, 3])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


# ---------------------------------------------------------------------------
# Sim3 — (..., 4, 4) with sR in the upper-left block
# ---------------------------------------------------------------------------

def sim3(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    return se3(R * s[..., None, None], t)


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    """Scale from the sR block (the norm of its first row)."""
    return torch.linalg.norm(S[..., 0, :3], dim=-1)


def sim3_rotation(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return sim3(sinv, Rt, -(sinv[..., None] * (Rt @ t[..., None])[..., 0]))


def _sim3_W_coeffs(sigma: torch.Tensor, theta: torch.Tensor):
    """Coefficients (a, b, c) of the Sim3 W-matrix
    Wm = a I + b hat(w) + c hat(w)^2 (Strasdat's Sim3 exponential), with
    the small-sigma and small-angle branches as ``torch.where`` guards."""
    s = torch.exp(sigma)
    eps = 1e-5
    one = torch.ones_like(sigma)
    sig_small = torch.abs(sigma) < eps
    sig_safe = torch.where(sig_small, one, sigma)
    a = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)

    th_small = theta < eps
    th = torch.where(th_small, torch.ones_like(theta), theta)
    th2 = th * th
    denom = sigma * sigma + th2
    denom = torch.where(denom < 1e-12, torch.ones_like(denom), denom)
    c_cos = s * torch.cos(th)
    c_sin = s * torch.sin(th)
    b_gen = (sigma * c_sin + (1.0 - c_cos) * th) / (th * denom)
    c_gen = (a - ((c_cos - 1.0) * sigma + c_sin * th) / denom) / th2

    b_th0 = torch.where(sig_small, 0.5 + sigma / 3.0,
                        (sigma * s - s + 1.0) / (sig_safe * sig_safe))
    c_th0 = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 8.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0
         - 0.5 * sigma * sigma) / (sig_safe ** 3))
    b = torch.where(th_small, b_th0, b_gen)
    c = torch.where(th_small, c_th0, c_gen)
    return a, b, c


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    a, b, c = _sim3_W_coeffs(sigma, safe_norm(w))
    W = hat(w)
    return (a[..., None, None] * _eye3_like(W) + b[..., None, None] * W
            + c[..., None, None] * (W @ W))


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim3 tangent (..., 7) = (v[3], w[3], sigma) -> (..., 4, 4) with sR."""
    v = xi[..., :3]
    w = xi[..., 3:6]
    sigma = xi[..., 6]
    t = (_sim3_W(w, sigma) @ v[..., None])[..., 0]
    return sim3(torch.exp(sigma), so3_exp(w), t)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) Sim3 -> tangent (..., 7) = (v, w, sigma)."""
    sigma = torch.log(sim3_scale(S))
    w = so3_log(sim3_rotation(S))
    # the closed-form 3x3 solve: a solver library call can check its
    # result on the host
    v = solve3x3(_sim3_W(w, sigma), S[..., :3, 3])
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def se3_to_sim3(T: torch.Tensor) -> torch.Tensor:
    return T


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop the scale (keep rotation + translation)."""
    return se3(sim3_rotation(S), S[..., :3, 3])
