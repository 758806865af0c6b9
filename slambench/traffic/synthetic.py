"""Synthetic SLAM world: landmarks, trajectories, feature-level views.

A frozen copy of ``snakeslam_tpu_torch/utils/synthetic.py`` as the
benchmark's traffic generator (tests/test_generators.py holds it equal to
the program's on a seed), so a change to the program's generator cannot
change the benchmark's inputs.  The scale pyramid's log factor is worked
out here instead of taken from the program.

No real datasets ship in this environment, so correctness and performance are
exercised on a procedurally generated world: random 3D landmarks with stable
256-bit descriptors, a smooth camera trajectory, and per-frame feature
extraction by projection with configurable pixel noise, descriptor bit flips,
outlier features, and dropout.  This mirrors the reference's feature-cache
replay path (reference: Snake/Preprocess/FeatureDetector.cpp:94-139), which
feeds recorded keypoints+descriptors into the pipeline instead of images.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


DESC_BYTES = 32


@dataclass
class SyntheticFrame:
    """Feature-level observation of the world from one pose."""

    timestamp: float
    pose_cw: np.ndarray          # (4, 4) world -> camera (ground truth)
    uv: np.ndarray               # (N, 2) pixel coords (noisy)
    octave: np.ndarray           # (N,) int32
    angle: np.ndarray            # (N,) degrees
    descriptors: np.ndarray      # (N, 32) uint8 packed
    depth: np.ndarray            # (N,) true depth (>0) or -1
    right: np.ndarray            # (N,) right-image x coord or -1
    point_id: np.ndarray         # (N,) ground-truth landmark id, -1 = clutter
    n: int = 0


@dataclass
class SyntheticWorld:
    n_points: int = 4000
    seed: int = 0
    image_size: tuple = (752, 480)
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    baseline: float = 0.11
    levels: int = 4
    scale_factor: float = 1.2
    extent: float = 12.0
    min_depth: float = 0.5
    max_depth: float = 40.0

    points: np.ndarray = field(init=False)
    descriptors: np.ndarray = field(init=False)
    angles: np.ndarray = field(init=False)
    ref_depth: np.ndarray = field(init=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # landmarks in a shell around the origin so orbiting cameras see them
        self.points = rng.uniform(-self.extent, self.extent, size=(self.n_points, 3))
        self.descriptors = rng.integers(
            0, 256, size=(self.n_points, DESC_BYTES), dtype=np.uint8
        )
        self.angles = rng.uniform(0, 360, size=(self.n_points,)).astype(np.float32)
        self.log_scale_factor = float(np.log(self.scale_factor))
        self.rng = rng
        self.ref_depth = np.full(self.n_points, -1.0)  # set at first observation

    @property
    def bf(self) -> float:
        return self.fx * self.baseline

    def camera_matrix(self):
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]]
        )

    def observe(
        self,
        pose_cw: np.ndarray,
        timestamp: float = 0.0,
        max_features: int = 1024,
        noise_px: float = 0.3,
        desc_flip_p: float = 0.01,
        n_clutter: int = 50,
        dropout: float = 0.0,
        with_depth: bool = False,
        with_stereo: bool = False,
        depth_limit: float | None = None,
    ) -> SyntheticFrame:
        """Render the feature-level view from pose_cw (world->cam)."""
        rng = self.rng
        W, H = self.image_size
        R = pose_cw[:3, :3]
        t = pose_cw[:3, 3]
        pc = self.points @ R.T + t
        z = pc[:, 2]
        vis = z > self.min_depth
        u = np.where(vis, pc[:, 0] / np.where(vis, z, 1.0) * self.fx + self.cx, -1)
        v = np.where(vis, pc[:, 1] / np.where(vis, z, 1.0) * self.fy + self.cy, -1)
        margin = 8
        vis &= (u >= margin) & (u < W - margin) & (v >= margin) & (v < H - margin)
        vis &= z < self.max_depth
        if dropout > 0:
            vis &= rng.random(self.n_points) >= dropout
        ids = np.nonzero(vis)[0]
        if len(ids) > max_features - n_clutter:
            ids = rng.choice(ids, size=max_features - n_clutter, replace=False)
            ids.sort()

        # set reference depth at first observation (drives octave consistency)
        first = self.ref_depth[ids] < 0
        self.ref_depth[ids[first]] = z[ids[first]]

        # octave from the scale-prediction rule so matching gates are coherent
        max_c = self.ref_depth[ids] * 1.0  # ref_level = 0 at first sight
        ratio = np.maximum(max_c / np.maximum(z[ids], 1e-9), 1e-9)
        octv = np.clip(
            np.ceil(np.log(ratio) / self.log_scale_factor),
            0,
            self.levels - 1,
        ).astype(np.int32)

        uv = np.stack([u[ids], v[ids]], axis=1)
        if noise_px > 0:
            uv = uv + rng.normal(scale=noise_px, size=uv.shape)
        desc = self.descriptors[ids].copy()
        if desc_flip_p > 0:
            flips = rng.random((len(ids), DESC_BYTES * 8)) < desc_flip_p
            flip_bytes = np.packbits(flips, axis=1, bitorder="little")
            desc ^= flip_bytes

        depth = np.full(len(ids), -1.0)
        right = np.full(len(ids), -1.0)
        zi = z[ids]
        if with_depth or with_stereo:
            lim = depth_limit if depth_limit is not None else self.max_depth
            has_d = zi < lim
            if with_depth:
                depth = np.where(has_d, zi, -1.0)
            if with_stereo:
                right = np.where(has_d, uv[:, 0] - self.bf / zi, -1.0)
                depth = np.where(has_d, zi, -1.0)

        # clutter features: random positions, random descriptors
        if n_clutter > 0:
            cuv = rng.uniform([0, 0], [W, H], size=(n_clutter, 2))
            cdesc = rng.integers(0, 256, size=(n_clutter, DESC_BYTES), dtype=np.uint8)
            uv = np.concatenate([uv, cuv])
            desc = np.concatenate([desc, cdesc])
            octv = np.concatenate(
                [octv, rng.integers(0, self.levels, size=n_clutter, dtype=np.int32)]
            )
            depth = np.concatenate([depth, np.full(n_clutter, -1.0)])
            right = np.concatenate([right, np.full(n_clutter, -1.0)])
            angle = np.concatenate(
                [self.angles[ids], rng.uniform(0, 360, n_clutter).astype(np.float32)]
            )
            ids = np.concatenate([ids, np.full(n_clutter, -1, dtype=ids.dtype)])
        else:
            angle = self.angles[ids]

        # shuffle so feature order carries no information
        perm = rng.permutation(len(ids))
        return SyntheticFrame(
            timestamp=timestamp,
            pose_cw=pose_cw.copy(),
            uv=uv[perm].astype(np.float64),
            octave=octv[perm],
            angle=angle[perm].astype(np.float32),
            descriptors=desc[perm],
            depth=depth[perm],
            right=right[perm],
            point_id=ids[perm].astype(np.int64),
            n=len(ids),
        )


def lookat_pose_cw(eye: np.ndarray, target: np.ndarray, up=(0, -1, 0)) -> np.ndarray:
    """World->camera pose with +z forward looking from eye to target."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, upv)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        upv = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, upv)
        nr = np.linalg.norm(right)
    right /= nr
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)  # columns = cam axes in world
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ eye
    return T


def orbit_trajectory(n_frames: int, radius: float = 6.0, height: float = 0.5,
                     arc: float = 1.2, fps: float = 20.0):
    """Camera orbiting the origin, looking inward. Yields (timestamp, pose_cw)."""
    for i in range(n_frames):
        a = arc * i / max(n_frames - 1, 1)
        eye = np.array([radius * np.sin(a), height * np.sin(2.5 * a),
                        -radius * np.cos(a)])
        yield i / fps, lookat_pose_cw(eye, np.zeros(3))


def loop_trajectory(n_frames: int, radius: float = 6.0, height: float = 0.5,
                    arc: float = 2.0 * np.pi * 1.08, fps: float = 20.0):
    """Camera orbiting the origin LOOKING OUTWARD — a loop-closure workload.

    Outward frustums on opposite orbit sides see disjoint regions of the
    point cloud (the inward-facing ``orbit_trajectory`` always shares the
    central region, so its keyframes stay covisible all the way around and
    no loop event can ever fire).  With ``arc`` slightly over 2*pi the
    trajectory revisits its start, the revisit keyframes are non-covisible
    with the originals, and the loop detector gets a genuine closure — the
    corridor-loop geometry of the reference's EuRoC MH sequences."""
    for i in range(n_frames):
        a = arc * i / max(n_frames - 1, 1)
        eye = np.array([radius * np.sin(a), height * np.sin(2.5 * a),
                        -radius * np.cos(a)])
        out = np.array([np.sin(a), 0.0, -np.cos(a)])
        yield i / fps, lookat_pose_cw(eye, eye + 4.0 * out)


def forward_trajectory(n_frames: int, speed: float = 0.6, fps: float = 20.0,
                       weave: float = 0.15):
    """Mostly-forward motion with gentle weave (EuRoC-like)."""
    for i in range(n_frames):
        s = speed * i / fps
        eye = np.array([weave * np.sin(0.8 * s), weave * np.cos(0.6 * s),
                        -10.0 + s])
        target = eye + np.array([0.25 * np.sin(0.3 * s), 0.0, 1.0])
        yield i / fps, lookat_pose_cw(eye, target)
