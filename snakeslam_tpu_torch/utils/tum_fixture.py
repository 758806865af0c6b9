"""A TUM-RGBD-format sequence rendered from the synthetic world.

Writes what ``frontend/datasets.TumRgbdDataset`` reads, in TUM's on-disk
format: ``rgb/<t>.png`` (8-bit gray views from
``utils/render_world.render_frame``), ``depth/<t>.png`` (16-bit, 5000 per
metre: each billboard's pixels carry its camera-frame z, the background is
0, i.e. invalid, as a Kinect's holes are), ``rgb.txt``, ``depth.txt`` and
``groundtruth.txt`` (camera-in-world poses, ``t tx ty tz qx qy qz qw``).
The camera orbits the world looking inward (``utils/synthetic.
orbit_trajectory``) through TUM freiburg1's intrinsics.  Everything is made
from the seed with numpy and written with PIL, so two machines write images
that decode to the same arrays, and the same trajectories.
"""

from __future__ import annotations

import configparser
import shutil
from pathlib import Path

import numpy as np

from snakeslam_tpu_torch.core import trajectory as traj
from snakeslam_tpu_torch.utils.render_world import _patches, render_frame
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld, orbit_trajectory

# TUM freiburg1 (configs/tum.ini's [Camera]); bf of the virtual depth camera
FR1 = dict(width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3)
FR1_BF = 40.0
DEPTH_PER_M = 5000.0
CONFIG = Path(__file__).resolve().parents[2] / "configs" / "tum.ini"
T0 = 1305031102.0     # a freiburg1-era unix time: TUM names files by it


def lane_world(seed: int = 7, n_points: int = 2000, scale: float = 1.0,
               extent: float = 2.5) -> SyntheticWorld:
    """A room-sized world (points in a cube of half-width ``extent`` m)
    seen through freiburg1's intrinsics, scaled by ``scale`` (0.5: the
    320x240 tests' camera)."""
    return SyntheticWorld(
        n_points=n_points, seed=seed,
        image_size=(int(FR1["width"] * scale), int(FR1["height"] * scale)),
        fx=FR1["fx"] * scale, fy=FR1["fy"] * scale,
        cx=FR1["cx"] * scale, cy=FR1["cy"] * scale,
        baseline=FR1_BF / FR1["fx"], extent=extent, min_depth=0.3,
        max_depth=12.0)


LANE_FRAMES = 300
LANE_ARC = 0.9        # rad over the lane: 0.32 m/s at 3.5 m and 30 Hz


def lane_trajectory(n_frames: int = LANE_FRAMES, fps: float = 30.0,
                    radius: float = 3.5):
    """(timestamp, pose_cw) of the first ``n_frames`` of the lane's inward
    orbit arc at TUM's 30 Hz, with TUM-style timestamps."""
    arc = LANE_ARC * (n_frames - 1) / (LANE_FRAMES - 1)
    return [(T0 + i / fps, T) for i, (_, T) in
            enumerate(orbit_trajectory(n_frames, radius=radius, arc=arc,
                                       fps=fps))]


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
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


def write_tum_fixture(root, world: SyntheticWorld, trajectory) -> dict:
    """Render ``trajectory`` [(t, T_cw)] of ``world`` into ``root`` in the
    TUM-RGBD layout.  Returns the frame count and the mean number of world
    points projected inside the image per frame."""
    from PIL import Image

    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    patches = _patches(len(world.points), world.seed)
    W, H = world.image_size
    lines = {"rgb": [], "depth": []}
    ts, pos, quat, in_view = [], [], [], []
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
        ts.append(t)
        pos.append(T_wc[:3, 3])
        quat.append(_quat_wxyz(T_wc[:3, :3]))
        pc = world.points @ T_cw[:3, :3].T + T_cw[:3, 3]
        zc = np.where(pc[:, 2] > world.min_depth, pc[:, 2], np.inf)
        u = world.fx * pc[:, 0] / zc + world.cx
        v = world.fy * pc[:, 1] / zc + world.cy
        in_view.append(int(((u >= 0) & (u < W) & (v >= 0) & (v < H)).sum()))
    for kind, rows in lines.items():
        (root / f"{kind}.txt").write_text(
            f"# {kind} images of a rendered synthetic sequence\n"
            + "\n".join(rows) + "\n")
    traj.write_tum(root / "groundtruth.txt", ts, pos, quat)
    return dict(frames=len(ts), points_in_view=float(np.mean(in_view)),
                min_points_in_view=int(np.min(in_view)))


def ate_against_groundtruth(est_path, gt_path, with_scale: bool = False):
    """(RMSE in m, matched count) of a TUM trajectory file against a TUM
    ground truth, camera centres associated by timestamp."""
    te, pe, _ = traj.read_tum(est_path)
    tg, pg, _ = traj.read_tum(gt_path)
    ia, ib = traj.associate(te, tg, max_dt=1e-3)
    rmse, _ = traj.ate_rmse(pe[ia], pg[ib], with_scale=with_scale)
    return rmse, len(ia)


def copy_config(dst, **overrides) -> Path:
    """configs/tum.ini copied to ``dst`` with ``overrides`` set (by key, in
    whichever section holds it): ``Settings.from_ini`` writes missing keys
    back into the file it reads, so a run never reads the repository's own
    INI."""
    dst = Path(dst)
    shutil.copy(CONFIG, dst)
    if overrides:
        cp = configparser.ConfigParser()
        cp.read(dst)
        for key, value in overrides.items():
            section = next(x for x in cp.sections() if cp.has_option(x, key))
            cp.set(section, key, str(value))
        with open(dst, "w") as f:
            cp.write(f)
    return dst
