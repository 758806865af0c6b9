"""Offline map/trajectory rendering to PNG.

Counterpart of ``snakeslam_tpu/viewer/plot.py``; matplotlib is an optional
import, loaded when a plot is drawn.

The reference renders the live map with OpenGL (Snake/Viewer/
SnakeOpenGLViewer.h: point cloud, keyframe frusta, covisibility graph,
trajectory).  This environment is headless, so the same ViewerMap
snapshot renders offline through matplotlib: top-down (x/z) and side
(z/y) orthographic views with map points, the keyframe trajectory,
covisibility edges, and the per-frame trajectory when provided.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from snakeslam_tpu_torch.viewer.export import snapshot_map


def plot_map(smap, out_path, trajectory=None,
             title: str = "snakeslam_tpu_torch",
             min_edge_weight: int = 20):
    """Render the map to ``out_path`` (PNG). Returns the path.

    Args:
      trajectory: optional (N, 4, 4) array / list of per-frame world->cam
        poses (SlamSystem.tracker.trajectory frames' ``pose_cw``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    snap = snapshot_map(smap, min_edge_weight=min_edge_weight)
    kf_centers = np.array([
        -T[:3, :3].T @ T[:3, 3] for T in snap.keyframe_poses
    ]).reshape(-1, 3)
    traj_centers = None
    if trajectory is not None and len(trajectory):
        poses = [getattr(f, "pose_cw", f) for f in trajectory]
        poses = [p for p in poses if p is not None]
        traj_centers = np.array([
            -np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3] for T in poses
        ]).reshape(-1, 3)

    fig, axes = plt.subplots(1, 2, figsize=(13, 6))
    for ax, (a, b, name) in zip(axes, [(0, 2, "top (x/z)"),
                                       (2, 1, "side (z/y)")]):
        if len(snap.points):
            ax.scatter(snap.points[:, a], snap.points[:, b], s=1.0,
                       c="#888888", alpha=0.5, linewidths=0)
        for e in snap.covis_edges:
            pa, pb = kf_centers[e[0]], kf_centers[e[1]]
            ax.plot([pa[a], pb[a]], [pa[b], pb[b]], color="#8bd88b",
                    linewidth=0.6, alpha=0.7, zorder=2)
        if traj_centers is not None:
            ax.plot(traj_centers[:, a], traj_centers[:, b], color="#3377cc",
                    linewidth=1.0, zorder=3)
        if len(kf_centers):
            ax.scatter(kf_centers[:, a], kf_centers[:, b], s=14,
                       c="#cc3333", marker="s", zorder=4)
        ax.set_title(f"{title} — {name}")
        ax.set_aspect("equal")
        ax.grid(True, alpha=0.2)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
