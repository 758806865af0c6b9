"""Synthetic dataset source: feature-level frames for tests and benchmarks.

Analog of the reference's feature-cache replay input path
(reference: Snake/Preprocess/FeatureDetector.cpp:94-139) — frames arrive as
keypoints+descriptors, bypassing image-space detection.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld


def apply_world_to_settings(world: SyntheticWorld, settings: Settings):
    settings.fx = world.fx
    settings.fy = world.fy
    settings.cx = world.cx
    settings.cy = world.cy
    settings.width, settings.height = world.image_size
    settings.bf = world.bf
    settings.fd_levels = world.levels
    settings.fd_scale_factor = world.scale_factor


def synthetic_frames(
    world: SyntheticWorld,
    trajectory,
    settings: Settings,
    noise_px: float = 0.3,
    desc_flip_p: float = 0.01,
    n_clutter: int = 50,
    max_features: int = 900,
    imu: dict | None = None,
):
    """Yield FrameData for each (timestamp, pose_cw) of a trajectory.

    Args:
      imu: optional dict(t, omega, acc, dt) of IMU samples (see
        utils/imu_synthetic.synth_imu); each frame carries the samples in
        (prev_ts, ts].
    """
    with_depth = settings.input_type == InputType.RGBD
    with_stereo = settings.input_type == InputType.Stereo
    prev_ts = None
    for i, (ts, pose_cw) in enumerate(trajectory):
        sf = world.observe(
            pose_cw,
            timestamp=ts,
            max_features=max_features,
            noise_px=noise_px,
            desc_flip_p=desc_flip_p,
            n_clutter=n_clutter,
            with_depth=with_depth or with_stereo,
            with_stereo=with_stereo,
        )
        fd = FrameData(
            frame_id=i,
            timestamp=ts,
            uv=sf.uv,
            octave=sf.octave,
            angle=sf.angle,
            descriptors=sf.descriptors,
            right=sf.right,
            depth=sf.depth,
            gt_pose_cw=sf.pose_cw,
        )
        if imu is not None and prev_ts is not None:
            sel = (imu["t"] >= prev_ts - 1e-9) & (imu["t"] < ts - 1e-9)
            fd.imu_omega = imu["omega"][sel]
            fd.imu_acc = imu["acc"][sel]
            fd.imu_dt = imu["dt"][sel]
            fd.imu_t = imu["t"][sel]
        prev_ts = ts
        yield fd
