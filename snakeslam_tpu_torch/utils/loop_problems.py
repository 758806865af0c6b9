"""Seeded loop-closure scenes for checking the system glue.

A ring of stereo keyframes looking outward from a circle of radius 7 m in
a synthetic world, ~20 degrees apart and one step past a full turn, so the
last keyframes revisit the first.  Map points sit at ground truth: each is
created from the first stereo feature that sees it (as the tracker creates
points) and observed by every later keyframe that sees it.

``drift_newest`` then makes the revisit a loop to close: the points shared
between the newest keyframes and the rest are split (the new side gets
clones, so the sides share no observation) and the new side, with the
points only it observes, moves by a Sim3 (the step drift of
tests/test_loop_reloc.py).

Used by the CPU parity tests (the same map copied into both packages) and
by ``chip_smoke.py`` (the scene on the CPU and on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.frontend.synthetic_source import (
    apply_world_to_settings,
)
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap, \
    transform_pose_cw
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld, \
    lookat_pose_cw

N_RING = 20
RING_STEP = 2.0 * np.pi * 1.05 / (N_RING - 1)
STEP_DRIFT = (0.25, -0.1, 0.15, 0.0, 0.03, 0.01, 0.0)   # Sim3 tangent


def ring_pose(a: float, radius: float = 7.0) -> np.ndarray:
    """World->camera pose at angle ``a`` on the ring, looking outward."""
    eye = np.array([radius * np.sin(a), 0.3 * np.sin(2.5 * a),
                    -radius * np.cos(a)])
    out = np.array([np.sin(a), 0.0, -np.cos(a)])
    return lookat_pose_cw(eye, eye + 4.0 * out)


def scene_settings(world: SyntheticWorld) -> Settings:
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.lba_cam_slots = 24
    s.lba_point_slots = 4096
    s.lba_obs_slots = 8
    s.th_depth = 25.0
    s.reloc_min_keyframes = 3
    apply_world_to_settings(world, s)
    return s


def frame_from(sf, frame_id: int, pose=None, cls=FrameData):
    """A ``cls`` frame of the synthetic view ``sf`` (ground truth kept)."""
    fd = cls(frame_id=frame_id, timestamp=float(frame_id), uv=sf.uv,
             octave=sf.octave, angle=sf.angle, descriptors=sf.descriptors,
             right=sf.right, depth=sf.depth, gt_pose_cw=sf.pose_cw.copy())
    fd.pose_cw = None if pose is None else pose.copy()
    return fd


def build_map(poses, n_points: int, seed: int, max_features: int = 620):
    """One stereo keyframe observed at each pose, chained in order.

    Returns (map, settings, world, {world point id: map point})."""
    world = SyntheticWorld(n_points=n_points, seed=seed)
    s = scene_settings(world)
    smap = SlamMap(64, 32768, s.feature_slots)
    pid_to_pt = {}
    prev = -1
    for i, pose in enumerate(poses):
        sf = world.observe(pose, timestamp=float(i),
                           max_features=max_features, noise_px=0.2,
                           n_clutter=20, with_stereo=True)
        kf = smap.allocate_keyframe(frame_from(sf, i, pose))
        smap.kf_prev[kf] = prev
        if prev >= 0:
            smap.kf_next[prev] = kf
        prev = kf
        cam = -pose[:3, :3].T @ pose[:3, 3]
        for feat, pid in enumerate(sf.point_id):
            if pid < 0:
                continue
            pt = pid_to_pt.get(int(pid))
            if pt is None:
                if sf.right[feat] <= 0:
                    continue   # points are created from stereo features
                normal = cam - world.points[pid]
                normal /= max(np.linalg.norm(normal), 1e-9)
                pt = smap.allocate_point(
                    world.points[pid].copy(), sf.descriptors[feat].copy(),
                    kf, float(sf.depth[feat]), 0, normal)
                pid_to_pt[int(pid)] = pt
            smap.add_observation(kf, feat, pt)
        smap.compute_median_depth(kf)
    for kf in smap.valid_keyframes():
        smap.update_spanning_tree_parent(int(kf))
    return smap, s, world, pid_to_pt


def build_ring():
    """``build_map`` of the ring: 20 keyframes, a 60000-point world,
    seed 31."""
    return build_map([ring_pose(i * RING_STEP) for i in range(N_RING)],
                     n_points=60000, seed=31)


def clone_map(smap, cls=SlamMap):
    """A new map of class ``cls`` holding ``smap``'s state (numpy arrays,
    counters, free lists); device caches and listeners are not copied."""
    out = cls(smap.max_keyframes, smap.max_points, smap.max_features)
    for k, v in vars(smap).items():
        if isinstance(v, np.ndarray):
            setattr(out, k, v.copy())
        elif k in ("_next_kf", "_next_pt", "state"):
            setattr(out, k, v)
        elif k in ("_free_pts", "_free_kfs"):
            setattr(out, k, list(v))
    return out


def drift_newest(smap: SlamMap, n_new: int = 3, xi=STEP_DRIFT):
    """Split the newest ``n_new`` keyframes off the rest and move them by
    ``sim3_exp(xi)``.  Returns (new-side keyframes in order, their true
    poses)."""
    kfs = [int(k) for k in smap.valid_keyframes()]
    new_side = set(kfs[-n_new:])
    for pt in list(smap.valid_points()):
        okfs, ofeats = smap.point_observations(int(pt))
        in_new = [(k, f) for k, f in zip(okfs, ofeats) if k in new_side]
        if in_new and len(in_new) < len(okfs):
            clone = smap.allocate_point(
                smap.pt_pos[pt].copy(), smap.pt_desc[pt].copy(),
                int(in_new[0][0]), float(smap.pt_ref_depth[pt]),
                int(smap.pt_ref_level[pt]), smap.pt_normal[pt].copy())
            for k, f in in_new:
                smap.remove_observation(int(k), int(f))
                smap.add_observation(int(k), int(f), clone)
    D = lie.sim3_exp(torch.tensor(xi, dtype=torch.float64)).numpy()
    s_d = float(np.linalg.norm(D[0, :3]))
    R_d, t_d = D[:3, :3] / s_d, D[:3, 3]
    truth = {k: smap.kf_pose[k].copy() for k in new_side}
    for k in new_side:
        smap.kf_pose[k] = transform_pose_cw(smap.kf_pose[k], s_d, R_d, t_d)
    for pt in smap.valid_points():
        okfs, _ = smap.point_observations(int(pt))
        if len(okfs) and all(k in new_side for k in okfs):
            smap.pt_pos[pt] = s_d * (R_d @ smap.pt_pos[pt]) + t_d
    smap.state += 1
    return sorted(new_side, key=lambda k: smap.kf_frame_id[k]), truth
