"""A TUM-RGBD-format sequence rendered from the synthetic world.

A frozen copy of ``snakeslam_tpu_torch/utils/tum_fixture.py``'s world,
trajectory and writer: ``rgb/<t>.png`` (8-bit gray), ``depth/<t>.png``
(16-bit, 5000 per metre, the background 0 as a Kinect's holes),
``rgb.txt``, ``depth.txt`` and ``groundtruth.txt`` (camera-in-world
poses, ``t tx ty tz qx qy qz qw``), through TUM freiburg1's intrinsics.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from traffic.render import _patches, render_frame
from traffic.synthetic import SyntheticWorld, orbit_trajectory

DEPTH_PER_M = 5000.0
T0 = 1305031102.0     # a freiburg1-era unix time: TUM names files by it


def room_world(camera: dict, seed: int, n_points: int,
               extent: float) -> SyntheticWorld:
    """A room-sized world (points in a cube of half-width ``extent`` m)
    seen through ``camera`` (fx, fy, cx, cy, width, height, bf)."""
    return SyntheticWorld(
        n_points=n_points, seed=seed,
        image_size=(int(camera["width"]), int(camera["height"])),
        fx=camera["fx"], fy=camera["fy"], cx=camera["cx"], cy=camera["cy"],
        baseline=camera["bf"] / camera["fx"], extent=extent, min_depth=0.3,
        max_depth=12.0)


def arc_trajectory(n_frames: int, fps: float, radius: float, arc: float):
    """(timestamp, pose_cw) of an inward orbit arc of ``arc`` rad over
    ``n_frames`` at ``fps``, with TUM-style timestamps."""
    return [(T0 + i / fps, T) for i, (_, T) in
            enumerate(orbit_trajectory(n_frames, radius=radius, arc=arc,
                                       fps=fps))]


def quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix, w >= 0."""
    m = R
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    q = np.asarray(q, dtype=np.float64)
    return q if q[0] >= 0 else -q


def write_sequence(root, world: SyntheticWorld, trajectory) -> list[str]:
    """Render ``trajectory`` [(t, T_cw)] of ``world`` into ``root`` in the
    TUM-RGBD layout; returns the rgb file names in order."""
    from PIL import Image

    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    patches = _patches(len(world.points), world.seed)
    lines = {"rgb": [], "depth": []}
    gt = []
    for t, T_cw in trajectory:
        gray, z = render_frame(world, T_cw, 0.0, patches, with_depth=True)
        name = f"{t:.6f}.png"
        Image.fromarray(np.clip(gray, 0, 255).astype(np.uint8)).save(
            root / "rgb" / name)
        Image.fromarray(np.round(z * DEPTH_PER_M).astype(np.uint16)).save(
            root / "depth" / name)
        for kind in lines:
            lines[kind].append(f"{t:.6f} {kind}/{name}")
        T_wc = np.linalg.inv(T_cw)
        p, q = T_wc[:3, 3], quat_wxyz(T_wc[:3, :3])
        gt.append(f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                  f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")
    for kind, rows in lines.items():
        (root / f"{kind}.txt").write_text(
            f"# {kind} images of a rendered synthetic sequence\n"
            + "\n".join(rows) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return [row.split()[1] for row in lines["rgb"]]
