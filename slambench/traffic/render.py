"""Render the synthetic world into grayscale and depth images.

A frozen copy of ``snakeslam_tpu_torch/utils/render_world.py``'s
``_patches`` and ``render_frame``: each landmark is a seeded billboard
stamped far-to-near onto a flat background at its sub-pixel projection.
"""

from __future__ import annotations

import numpy as np

PATCH = 13          # default billboard side (odd)


def _patches(n_points: int, seed: int, patch: int = PATCH) -> np.ndarray:
    """Distinctive billboard textures: blocky tiles of ceil(patch/cells)
    px (~3 px at the default patch=13; FAST corners at every tile
    junction) with CONTINUOUS intensities.  Quantized levels
    make billboards mutually self-similar, which starves ratio-test knn
    matching (mono init, BoW) of unambiguous correspondences; continuous
    tiles keep the corner geometry while making every billboard unique."""
    rng = np.random.default_rng(seed + 991)
    cells = max(patch // 4, 5)
    base = rng.uniform(15.0, 235.0,
                       size=(n_points, cells, cells)).astype(np.float32)
    reps = -(-patch // cells)
    up = np.repeat(np.repeat(base, reps, axis=1), reps, axis=2)
    return up[:, :patch, :patch]


def render_frame(world, T_cw: np.ndarray, baseline: float = 0.0,
                 patches: np.ndarray | None = None, with_depth: bool = False):
    """Render one grayscale (H, W) float32 view of the world.

    Args:
      T_cw: 4x4 world->camera pose; ``baseline`` shifts the camera left
        by that many meters along +x camera (for the stereo right view
        pass baseline=world.baseline).
      with_depth: also return the (H, W) float32 depth image: each
        billboard's pixels carry its camera-frame z, the background 0.
    """
    W, H = world.image_size
    img = np.full((H, W), 110.0, dtype=np.float32)
    depth = np.zeros((H, W), dtype=np.float32) if with_depth else None
    if patches is None:
        patches = _patches(len(world.points), world.seed)
    psz = patches.shape[1]
    pc = world.points @ T_cw[:3, :3].T + T_cw[:3, 3]
    if baseline:
        pc = pc - np.array([baseline, 0.0, 0.0])
    z = pc[:, 2]
    vis = z > world.min_depth
    u = world.fx * pc[:, 0] / np.where(vis, z, 1.0) + world.cx
    v = world.fy * pc[:, 1] / np.where(vis, z, 1.0) + world.cy
    r = psz // 2
    ui = np.floor(u).astype(np.int64)
    vi = np.floor(v).astype(np.int64)
    vis &= (ui >= r) & (ui + r + 1 < W) & (vi >= r) & (vi + r + 1 < H)
    order = np.argsort(-z)  # far first so near billboards overdraw
    pad = np.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
    for i in order:
        if not vis[i]:
            continue
        # subpixel placement: bilinear-shift the billboard by the
        # fractional projection offset so feature localization carries
        # true sub-pixel geometry (integer stamping adds +-0.5 px of
        # systematic jitter that dominates the e2e ATE)
        dx = u[i] - ui[i]
        dy = v[i] - vi[i]
        p = pad[i]
        shifted = ((1 - dy) * (1 - dx) * p[1:1 + psz, 1:1 + psz]
                   + (1 - dy) * dx * p[1:1 + psz, 0:psz]
                   + dy * (1 - dx) * p[0:psz, 1:1 + psz]
                   + dy * dx * p[0:psz, 0:psz])
        img[vi[i] - r:vi[i] + r + 1, ui[i] - r:ui[i] + r + 1] = shifted
        if with_depth:
            depth[vi[i] - r:vi[i] + r + 1, ui[i] - r:ui[i] + r + 1] = z[i]
    return (img, depth) if with_depth else img


def render_sequence(world, trajectory, stereo: bool = True,
                    patch: int = PATCH):
    """Yield (timestamp, pose_cw, left_img, right_img|None) per pose."""
    patches = _patches(len(world.points), world.seed, patch)
    for ts, T_cw in trajectory:
        left = render_frame(world, T_cw, 0.0, patches)
        right = (render_frame(world, T_cw, world.baseline, patches)
                 if stereo else None)
        yield ts, T_cw, left, right
