"""TSDF voxel fusion for dense RGB-D preview.

Counterpart of ``snakeslam_tpu/ops/tsdf.py``, the replacement for saiga's
``VoxelFusion`` used by the reference's dense-preview viewer (reference:
Snake/Viewer/VisualVoxelFusion.{h,cpp}, FusionScene).  The truncated
signed distance field is a dense (V, V, V) tensor on the volume's device;
integrating a depth frame is one pass of elementwise torch ops (project
every voxel centre, gather the depth at the rounded pixel, truncated SDF
update with running weights): the KinectFusion update.  The camera-frame
coordinates are formed as elementwise products and sums in a fixed order,
so the card and the CPU pick the same pixel for every voxel.

Surface export samples the zero crossing by thresholding |tsdf|.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TsdfVolume(NamedTuple):
    tsdf: torch.Tensor      # (V, V, V) f32 in [-1, 1]
    weight: torch.Tensor    # (V, V, V) f32
    origin: torch.Tensor    # (3,) world position of voxel (0,0,0)
    voxel_size: torch.Tensor  # () f32


def create_volume(resolution: int = 128, extent: float = 4.0,
                  origin=(-2.0, -2.0, -2.0), *, device) -> TsdfVolume:
    f32 = torch.float32
    return TsdfVolume(
        tsdf=torch.ones((resolution,) * 3, dtype=f32, device=device),
        weight=torch.zeros((resolution,) * 3, dtype=f32, device=device),
        origin=torch.tensor(origin, dtype=f32, device=device),
        voxel_size=torch.tensor(extent / resolution, dtype=f32,
                                device=device),
    )


def integrate(vol: TsdfVolume, depth: torch.Tensor, T_cw: torch.Tensor,
              fx: float, fy: float, cx: float, cy: float, trunc: float,
              max_weight: float = 64.0) -> TsdfVolume:
    """Fuse one (H, W) metric depth frame (<= 0 invalid) seen from the
    world->camera pose ``T_cw`` (4, 4) into the volume."""
    f32 = torch.float32
    dev = vol.tsdf.device
    V = vol.tsdf.shape[0]
    H, W = depth.shape
    depth = depth.to(device=dev, dtype=f32)
    T = T_cw.to(device=dev, dtype=f32)
    vs = vol.voxel_size
    idx = torch.arange(V, dtype=f32, device=dev)
    # voxel centres per axis, (V,) each, broadcast to (V, V, V) below
    c = [idx * vs + vol.origin[k] + 0.5 * vs for k in range(3)]
    ax = [c[0][:, None, None], c[1][None, :, None], c[2][None, None, :]]
    pc = [ax[0] * T[r, 0] + ax[1] * T[r, 1] + ax[2] * T[r, 2] + T[r, 3]
          for r in range(3)]
    z = pc[2]
    front = z > 1e-4
    zs = torch.where(front, z, 1.0)
    u = fx * pc[0] / zs + cx
    v = fy * pc[1] / zs + cy
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    d = depth.reshape(-1)[vi * W + ui]
    in_view = front & (u >= 0) & (u < W) & (v >= 0) & (v < H) & (d > 0)
    sdf = (d - z) / trunc
    update = in_view & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    w_new = update.to(f32)
    w_tot = vol.weight + w_new
    tsdf = torch.where(
        w_tot > 0,
        (vol.tsdf * vol.weight + sdf * w_new) / torch.clamp(w_tot, min=1e-6),
        vol.tsdf,
    )
    return TsdfVolume(tsdf=tsdf, weight=torch.clamp(w_tot, max=max_weight),
                      origin=vol.origin, voxel_size=vol.voxel_size)


def extract_surface_points(vol: TsdfVolume, iso_band: float = 0.25,
                           min_weight: float = 1.0) -> np.ndarray:
    """World-space centres of near-surface voxels (dense preview)."""
    tsdf = vol.tsdf.cpu().numpy()
    weight = vol.weight.cpu().numpy()
    mask = (np.abs(tsdf) < iso_band) & (weight >= min_weight)
    ijk = np.argwhere(mask).astype(np.float64)
    vs = float(vol.voxel_size)
    return ijk * vs + vol.origin.cpu().numpy() + 0.5 * vs
