"""Feature-level frames of a synthetic world along a trajectory.

A frozen copy of ``snakeslam_tpu_torch/frontend/synthetic_source.py``'s
``synthetic_frames``: the same calls into the world's random generator in
the same order, so a seed gives the program's own frames.  It keeps each
frame's arrays (and the ground truth, which the program is not given) in a
``RawFrame``; ``frame_data`` builds the program's input type from one,
or from any generator's raw frame.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np


@dataclass
class RawFrame:
    frame_id: int
    timestamp: float
    uv: np.ndarray
    octave: np.ndarray
    angle: np.ndarray
    descriptors: np.ndarray
    right: np.ndarray
    depth: np.ndarray
    gt_pose_cw: np.ndarray      # world -> camera, the generator's truth
    point_id: np.ndarray        # ground-truth landmark per feature, -1 clutter


def feature_frames(world, trajectory, stereo: bool, rgbd: bool = False,
                   noise_px: float = 0.3, desc_flip_p: float = 0.01,
                   n_clutter: int = 50, max_features: int = 900):
    """Yield one ``RawFrame`` per (timestamp, pose_cw) of ``trajectory``."""
    for i, (ts, pose_cw) in enumerate(trajectory):
        sf = world.observe(
            pose_cw,
            timestamp=ts,
            max_features=max_features,
            noise_px=noise_px,
            desc_flip_p=desc_flip_p,
            n_clutter=n_clutter,
            with_depth=rgbd or stereo,
            with_stereo=stereo,
        )
        yield RawFrame(frame_id=i, timestamp=ts, uv=sf.uv, octave=sf.octave,
                       angle=sf.angle, descriptors=sf.descriptors,
                       right=sf.right, depth=sf.depth,
                       gt_pose_cw=sf.pose_cw, point_id=sf.point_id)


TRUTH = ("gt_pose_cw", "point_id")    # the generator's, never the program's


def frame_data(raw, FrameData):
    """The program's ``FrameData`` of ``raw``, made anew for each session
    (the system writes its tracking state into the object): each field
    that ``FrameData`` declares and ``raw`` carries, the IMU samples
    included where a generator gives them; never the ground truth."""
    return FrameData(**{f.name: getattr(raw, f.name)
                        for f in fields(FrameData)
                        if f.init and f.name not in TRUTH
                        and hasattr(raw, f.name)})
