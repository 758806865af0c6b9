"""Preprocessing: keypoint undistortion, stereo matching, RGBD association.

Counterpart of ``snakeslam_tpu/frontend/preprocess.py``, mirroring the
reference's Preprocess module (Snake/Preprocess/Preprocess.{h,cpp}):
Gauss-Newton keypoint undistortion (:55-77, batched in core/camera.undistort),
RGBD depth lookup -> virtual right point (:79-120), and rectified-stereo
descriptor matching with row/octave/disparity gates (:122-242) over one
dense Hamming matrix on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Distortion, Pinhole, undistort
from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.ops.descriptors import hamming_matrix, unpack_bits_np
from snakeslam_tpu_torch.system.settings import Settings


class Preprocess:
    def __init__(self, settings: Settings,
                 distortion: Distortion | None = None, *, device):
        self.s = settings
        self.device = torch.device(device)
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=self.device)
        self.distortion = distortion

    # ------------------------------------------------------------------

    def undistort_keypoints(self, frame: FrameData):
        """In-place undistortion of frame.uv (no-op for zero distortion)."""
        if self.distortion is None or self.distortion.is_zero():
            return
        uv = torch.as_tensor(frame.uv, dtype=torch.float32,
                             device=self.device)
        xn = undistort(self.cam.unproject_pixels(uv), self.distortion)
        frame.uv = self.cam.project_normalized(xn).cpu().numpy().astype(
            np.float64)

    # ------------------------------------------------------------------

    def depth_from_rgbd(self, frame: FrameData, depth_image: np.ndarray,
                        depth_scale: float = 1.0):
        """Sample the depth map at keypoints; fill depth + virtual right
        (Preprocess.cpp:79-120)."""
        H, W = depth_image.shape
        x = np.clip(np.round(frame.uv[:, 0]).astype(int), 0, W - 1)
        y = np.clip(np.round(frame.uv[:, 1]).astype(int), 0, H - 1)
        z = depth_image[y, x].astype(np.float64) * depth_scale
        ok = z > 0
        frame.depth = np.where(ok, z, -1.0)
        if self.s.bf > 0:
            frame.right = np.where(
                ok, frame.uv[:, 0] - self.s.bf / np.maximum(z, 1e-9), -1.0
            )

    # ------------------------------------------------------------------

    def stereo_match(self, frame: FrameData, right_frame: FrameData,
                     row_tolerance: float = 2.0, max_hamming: int = 60):
        """Rectified stereo matching: left keypoints vs right keypoints with
        row / octave / disparity gates (Preprocess.cpp:122-242), evaluated
        as one dense masked Hamming matrix.

        Fills frame.right and frame.depth for matched left features.
        """
        if right_frame.n == 0 or frame.n == 0:
            return 0
        bl = torch.from_numpy(unpack_bits_np(frame.descriptors)).to(
            self.device)
        br = torch.from_numpy(unpack_bits_np(right_frame.descriptors)).to(
            self.device)
        H = hamming_matrix(bl, br).cpu().numpy()

        du_row = np.abs(
            frame.uv[:, 1][:, None] - right_frame.uv[:, 1][None, :]
        )
        tol = row_tolerance * (
            2.0 if self.s.fd_relaxed_stereo else 1.0
        )
        disparity = frame.uv[:, 0][:, None] - right_frame.uv[:, 0][None, :]
        max_disp = self.s.bf / 0.3 if self.s.bf > 0 else 200.0  # z >= 0.3 m
        oct_ok = np.abs(
            frame.octave[:, None] - right_frame.octave[None, :]
        ) <= 1
        cand = (
            (du_row <= tol) & (disparity > 0.1) & (disparity < max_disp)
            & oct_ok & (H <= max_hamming)
        )
        Hm = np.where(cand, H, 999)
        best = Hm.min(axis=1)
        best_j = Hm.argmin(axis=1)
        matched = best <= max_hamming
        disp = frame.uv[:, 0] - right_frame.uv[best_j, 0]
        z = np.where(matched & (disp > 0.1), self.s.bf / np.maximum(disp, 0.1),
                     -1.0)
        frame.right = np.where(z > 0, right_frame.uv[best_j, 0], -1.0)
        frame.depth = np.where(z > 0, z, -1.0)
        return int((z > 0).sum())
