"""Pinhole camera and stereo projection on tensors.

Counterpart of ``snakeslam_tpu/core/camera.py`` for the parts the stereo
tracking slice uses (distortion comes with the pixels-in front-end).
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

    def unproject_pixels(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> normalized coords (..., 2)."""
        return torch.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            dim=-1,
        )


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
