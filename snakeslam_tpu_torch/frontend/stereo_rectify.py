"""Stereo rectification setup — no OpenCV dependency.

Counterpart of ``snakeslam_tpu/frontend/stereo_rectify.py``, the
replacement for the reference's StereoTransforms, which wraps
``cv::stereoRectify`` (reference: Snake/Preprocess/StereoTransforms.cpp:
19-95): computes the rectifying rotations for both cameras
(Fusiello-style), the shared rectified intrinsics, and the ``bf`` product,
and provides batched keypoint rectification (undistort -> rotate ->
reproject) matching the per-keypoint path in Preprocess.cpp:55-77.  The
keypoints go through the port's ``core/camera`` on the cameras' device in
the cameras' dtype (float64 for the rectified camera).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Distortion, Pinhole, undistort


@dataclass
class Rectification:
    R_rect: np.ndarray       # (3, 3) rectifying rotation for this camera
    cam_old: Pinhole         # original intrinsics
    cam_new: Pinhole         # rectified intrinsics (shared by the pair)
    distortion: Distortion | None

    def rectify_points(self, uv: np.ndarray) -> np.ndarray:
        """Pixels in the raw image -> pixels in the rectified image."""
        dev = self.cam_new.fx.device
        uvt = torch.as_tensor(np.asarray(uv), dtype=torch.float64,
                              device=dev)
        xn = self.cam_old.unproject_pixels(uvt)
        if self.distortion is not None and not self.distortion.is_zero():
            xn = undistort(xn, self.distortion)
        ones = torch.ones(xn.shape[:-1] + (1,), dtype=xn.dtype, device=dev)
        rays = torch.cat([xn, ones], dim=-1)
        rot = rays @ torch.as_tensor(self.R_rect, dtype=xn.dtype,
                                     device=dev).T
        xn2 = rot[..., :2] / rot[..., 2:3]
        return self.cam_new.project_normalized(xn2).cpu().numpy()


def stereo_rectify(
    cam_left: Pinhole,
    cam_right: Pinhole,
    R_rl: np.ndarray,
    t_rl: np.ndarray,
    dist_left: Distortion | None = None,
    dist_right: Distortion | None = None,
):
    """Compute rectifying transforms for a calibrated stereo pair.

    Args:
      R_rl, t_rl: extrinsics mapping left-camera coords to right-camera
        coords (x_r = R_rl x_l + t_rl).
    Returns (rect_left, rect_right, bf): Rectification for each camera and
    the baseline*focal product of the rectified pair.
    """
    R_rl = np.asarray(R_rl, dtype=np.float64)
    t_rl = np.asarray(t_rl, dtype=np.float64)
    # right camera center in the left frame
    c_r = -R_rl.T @ t_rl
    baseline = np.linalg.norm(c_r)
    x_new = c_r / max(baseline, 1e-12)
    if x_new[0] < 0:
        x_new = -x_new
    # split the relative rotation evenly between the two views for minimal
    # distortion: z from the average optical axis
    w = lie.so3_log(torch.tensor(R_rl)).numpy()
    R_half = lie.so3_exp(torch.from_numpy(-0.5 * w)).numpy()
    z_avg = R_half @ np.array([0.0, 0.0, 1.0])
    y_new = np.cross(z_avg, x_new)
    y_new /= max(np.linalg.norm(y_new), 1e-12)
    z_new = np.cross(x_new, y_new)
    R_rect_l = np.stack([x_new, y_new, z_new])       # rows = new axes
    R_rect_r = R_rect_l @ R_rl.T

    fx = 0.5 * (float(cam_left.fx) + float(cam_right.fx))
    fy = 0.5 * (float(cam_left.fy) + float(cam_right.fy))
    cx = float(cam_left.cx)
    cy = 0.5 * (float(cam_left.cy) + float(cam_right.cy))
    cam_new = Pinhole.create(fx, fy, cx, cy, device=cam_left.fx.device,
                             dtype=torch.float64)

    rect_l = Rectification(R_rect_l, cam_left, cam_new, dist_left)
    rect_r = Rectification(R_rect_r, cam_right, cam_new, dist_right)
    return rect_l, rect_r, fx * baseline
