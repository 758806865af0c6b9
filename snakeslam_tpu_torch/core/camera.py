"""Pinhole camera and stereo projection on tensors.

Counterpart of ``snakeslam_tpu/core/camera.py``: pinhole intrinsics,
Brown-Conrady distortion and its Gauss-Newton inverse (the keypoint
undistortion of the pixels-in front-end), stereo projection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pinhole(NamedTuple):
    """Pinhole intrinsics as 0-d tensors on the working device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, device=None,
               dtype=torch.float32) -> "Pinhole":
        def f(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return Pinhole(f(fx), f(fy), f(cx), f(cy))

    def project_normalized(self, xn: torch.Tensor) -> torch.Tensor:
        """Normalized coords (..., 2) -> pixels (..., 2)."""
        return torch.stack(
            [xn[..., 0] * self.fx + self.cx, xn[..., 1] * self.fy + self.cy],
            dim=-1,
        )

    def unproject_pixels(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> normalized coords (..., 2)."""
        return torch.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            dim=-1,
        )


class Distortion(NamedTuple):
    """Brown-Conrady (radtan) distortion: k1 k2 k3 radial + p1 p2 tangential,
    as 0-d tensors.  EuRoC/TUM calibrations use (k1, k2, p1, p2[, k3]);
    extra coefficients default to zero."""

    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, device=None,
               dtype=torch.float32) -> "Distortion":
        def f(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return Distortion(f(k1), f(k2), f(k3), f(p1), f(p2))

    def is_zero(self) -> bool:
        return all(bool((v == 0).all()) for v in self)


def distort(xn: torch.Tensor, d: Distortion) -> torch.Tensor:
    """Apply distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (d.k1 + r2 * (d.k2 + r2 * d.k3))
    xy2 = 2.0 * x * y
    xd = x * radial + d.p1 * xy2 + d.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + d.p2 * xy2 + d.p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def undistort(xd: torch.Tensor, d: Distortion, iters: int = 8) -> torch.Tensor:
    """Invert ``distort`` with a fixed number of Gauss-Newton steps from the
    distorted point (saiga's ``undistortPointGN``), over all points."""
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (d.k1 + r2 * (d.k2 + r2 * d.k3))
        dradial_dr2 = d.k1 + r2 * (2.0 * d.k2 + 3.0 * d.k3 * r2)
        fx = x * radial + d.p1 * 2.0 * x * y + d.p2 * (r2 + 2.0 * x * x)
        fy = y * radial + d.p2 * 2.0 * x * y + d.p1 * (r2 + 2.0 * y * y)
        J00 = radial + x * dradial_dr2 * 2.0 * x + 2.0 * d.p1 * y + 6.0 * d.p2 * x
        J01 = x * dradial_dr2 * 2.0 * y + 2.0 * d.p1 * x + 2.0 * d.p2 * y
        J10 = y * dradial_dr2 * 2.0 * x + 2.0 * d.p2 * y + 2.0 * d.p1 * x
        J11 = radial + y * dradial_dr2 * 2.0 * y + 2.0 * d.p2 * x + 6.0 * d.p1 * y
        rx = fx - xd[..., 0]
        ry = fy - xd[..., 1]
        det = J00 * J11 - J01 * J10
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                          det)
        dx = (J11 * rx - J01 * ry) / det
        dy = (-J10 * rx + J00 * ry) / det
        xn = torch.stack([x - dx, y - dy], dim=-1)
    return xn


class StereoCamera(NamedTuple):
    """Rectified pinhole + ``bf`` = baseline * fx; the virtual right x of a
    point at depth Z is ``u - bf / Z``."""

    cam: Pinhole
    bf: torch.Tensor

    @property
    def baseline(self) -> torch.Tensor:
        return self.bf / self.cam.fx


def project(cam: Pinhole, pc: torch.Tensor, eps: float = 1e-6):
    """Camera-space points (..., 3) -> (uv (..., 2), z (...,)).

    z <= eps points produce garbage uv; callers mask with z > 0."""
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    u = pc[..., 0] / zs * cam.fx + cam.cx
    v = pc[..., 1] / zs * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(scam: StereoCamera, pc: torch.Tensor, eps: float = 1e-6):
    """Camera-space points (..., 3) -> (uvr (..., 3) = (u, v, u_right), z)."""
    uv, z = project(scam.cam, pc, eps)
    zs = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    ur = uv[..., 0] - scam.bf / zs
    return torch.cat([uv, ur[..., None]], dim=-1), z


def unproject(cam: Pinhole, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-space (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)
