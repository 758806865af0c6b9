"""Sparse depth-completion grid for depth-guided triangulation.

Replacement for the reference's Triangulator::ComputeDepthMap
(reference: Snake/LocalMapping/Triangulator.cpp:296-373): observed
map-point depths scatter into a coarse cell grid, unknown cells
forward-fill down columns then along rows, and five Jacobi averaging
passes smooth the unobserved cells.  The grid gives every *free* feature
a depth prior, which the dense triangulation matcher uses as a projection
window to break epipolar-line ambiguity
(MappingORBMatcher::SearchForTriangulationProject, :168-250).

The grid is ~10x16 cells built from host-resident map state (point
depths, observation table), so it is computed in numpy at keyframe rate —
a device call would cost more than the arithmetic — and shipped to the
jitted pair-triangulation kernel as a small input array.  The reference
randomly drops 33% of the scatter sources as a CPU-time optimization
(Triangulator.cpp:313); we keep all sources and stay deterministic.
"""

from __future__ import annotations

import numpy as np

CELL_PX = 48.0          # ~4 ORB feature-grid cells, like the reference's /4
SMOOTH_ITERS = 5


def grid_shape(width: int, height: int, cell_px: float = CELL_PX):
    return (max(int(height // cell_px), 1), max(int(width // cell_px), 1))


def build_depth_grid(uv: np.ndarray, z: np.ndarray, width: int, height: int,
                     cell_px: float = CELL_PX,
                     smooth_iters: int = SMOOTH_ITERS) -> np.ndarray:
    """(n,2) pixel coords + (n,) positive depths -> (GH, GW) f32 grid.

    Cells without any filled value anywhere remain 0 (no prior).
    """
    GH, GW = grid_shape(width, height, cell_px)
    grid = np.zeros((GH, GW), dtype=np.float32)
    known = np.zeros((GH, GW), dtype=bool)
    pos = z > 0
    if pos.any():
        gx = np.clip((uv[pos, 0] / width * GW).astype(np.int64), 0, GW - 1)
        gy = np.clip((uv[pos, 1] / height * GH).astype(np.int64), 0, GH - 1)
        # later sources overwrite earlier ones, like the reference's loop
        grid[gy, gx] = z[pos]
        known[gy, gx] = True

    # forward fill down each column, then along each row
    # (Triangulator.cpp:326-355)
    for axis_grid in (grid, grid.T):
        rows, cols = axis_grid.shape
        for j in range(cols):
            current = 0.0
            col = axis_grid[:, j]
            for i in range(rows):
                if col[i] == 0.0:
                    col[i] = current
                else:
                    current = col[i]

    # Jacobi smoothing of the UNOBSERVED interior cells
    # (Triangulator.cpp:357-372)
    for _ in range(smooth_iters):
        interior = grid[1:-1, 1:-1]
        nb = 0.25 * (grid[2:, 1:-1] + grid[:-2, 1:-1]
                     + grid[1:-1, 2:] + grid[1:-1, :-2])
        grid[1:-1, 1:-1] = np.where(known[1:-1, 1:-1], interior, nb)
    return grid


def keyframe_depth_grid(smap, kf: int, width: int, height: int,
                        cell_px: float = CELL_PX) -> np.ndarray:
    """Depth grid from keyframe ``kf``'s observed map points."""
    n = int(smap.kf_n_feat[kf])
    obs = smap.kf_obs[kf, :n]
    sel = np.nonzero(obs >= 0)[0]
    if len(sel) == 0:
        return np.zeros(grid_shape(width, height, cell_px), dtype=np.float32)
    pts = obs[sel]
    T = smap.kf_pose[kf]
    pc = smap.pt_pos[pts] @ T[:3, :3].T + T[:3, 3]
    return build_depth_grid(smap.kf_feat_uv[kf, sel], pc[:, 2],
                            width, height, cell_px)
