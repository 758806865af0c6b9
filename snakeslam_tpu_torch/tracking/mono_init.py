"""Monocular two-frame bootstrap.

Counterpart of ``snakeslam_tpu/tracking/mono_init.py`` (the reference's
MonoInitializer, Snake/Tracking/Initialization/MonoInitializer.{h,cpp}):
quality presets
(MonoInitializer.h:25-91), guided descriptor matching with a search-radius
gate (:619-694 — 50 px), 8-point essential RANSAC with inlier polish
(:172-232), degeneracy gates — match count, median flow, inlier count,
median parallax angle, homography-inlier ratio for planar scenes
(:96-276) — two-view BA refinement, and median-depth normalization to
``target_scale = 3`` (:274, MonoInitializer.h:154) before creating the
first two keyframes and their map points (:278-393).

The RANSACs' hypotheses are the JAX package's: a threefry key seeded with
the settings' ``random_seed``, split into (key, k1, k2) once per frame pair
that reaches the RANSACs, k1 drawing the essential hypotheses and k2 the
homography's (``core/prng.py``; the same draws on every device).  The
two-view geometry (both RANSACs and the pose recovery) runs on the host
whatever the system's device, so a card initializes exactly as the CPU
does: the batched float32 ``eigh`` of the 8-point normal matrices is
ill-conditioned, and the card's rounds otherwise, which moved inlier
counts and the landing frame (PERF.md section 6).  The two-view BA runs
on the system's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.ops import ba as BA
from snakeslam_tpu_torch.ops.descriptors import unpack_bits_np
from snakeslam_tpu_torch.ops.matching import knn2_ratio_match_np
from snakeslam_tpu_torch.ops.twoview import (
    essential_ransac,
    homography_ransac,
    recover_pose_from_essential,
)


@dataclass
class MonoInitSettings:
    """Quality presets (reference: MonoInitializer.h:25-91, quality 0..2)."""

    min_matches: int = 100
    min_inliers: int = 80
    min_median_flow_px: float = 10.0
    max_homography_ratio: float = 0.9
    min_median_angle_deg: float = 0.9
    search_radius_px: float = 50.0
    target_scale: float = 3.0
    ransac_threshold_px: float = 1.7
    # feature-coverage gates (MonoInitializer.h:69-89): fraction of 48x48-px
    # image bins that must contain features
    min_histogram_density: float = 0.3

    @staticmethod
    def for_quality(q: int) -> "MonoInitSettings":
        if q <= 0:
            return MonoInitSettings(min_matches=60, min_inliers=50,
                                    min_median_angle_deg=0.5,
                                    min_histogram_density=0.3)
        if q >= 2:
            return MonoInitSettings(min_matches=150, min_inliers=120,
                                    min_median_angle_deg=1.2,
                                    min_histogram_density=0.5)
        return MonoInitSettings()


def feature_histogram_density(uv: np.ndarray, width: int, height: int,
                              bin_px: int = 48) -> float:
    """Fraction of bin_px x bin_px image bins containing >= 1 feature
    (featureHistogram, MonoInitializer.cpp:395-412)."""
    bw = max(width // bin_px, 1)
    bh = max(height // bin_px, 1)
    if len(uv) == 0:
        return 0.0
    bx = np.clip((uv[:, 0] * bw / width).astype(np.int64), 0, bw - 1)
    by = np.clip((uv[:, 1] * bh / height).astype(np.int64), 0, bh - 1)
    occupied = len(np.unique(by * bw + bx))
    return occupied / float(bw * bh)


class MonoInitializer:
    def __init__(self, settings, device, quality: int = 1, seed: int = 0):
        self.s = settings
        self.device = torch.device(device)
        self.cfg = MonoInitSettings.for_quality(quality)
        self.ref_frame: FrameData | None = None
        self.key = prng.PRNGKey(seed)
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=self.device)
        self.n_attempts = 0      # frame pairs that reached the RANSACs

    # ------------------------------------------------------------------

    def _guided_match(self, f1: FrameData, f2: FrameData):
        """Descriptor knn with a flow-radius gate (optical-flow-style guided
        matching, MonoInitializer.cpp:619-694)."""
        idx, dist = knn2_ratio_match_np(
            unpack_bits_np(f1.descriptors), unpack_bits_np(f2.descriptors),
            ratio=0.8, max_dist=64, cross_check=True, device=self.device,
        )
        sel = idx >= 0
        # radius gate
        flow = np.linalg.norm(
            f1.uv[sel] - f2.uv[idx[sel]], axis=1
        )
        keep = flow <= self.cfg.search_radius_px
        i1 = np.nonzero(sel)[0][keep]
        i2 = idx[i1]
        return i1, i2

    # ------------------------------------------------------------------

    def try_initialize(self, tracker, frame: FrameData) -> bool:
        if self.ref_frame is None:
            # first-frame selection: reject texture-poor frames whose
            # features cover too few image bins (selectFirstFrame,
            # MonoInitializer.cpp:469-514 — the reference skip-searches its
            # frame buffer; streaming, we test each arriving frame)
            density = feature_histogram_density(
                frame.uv[: frame.n], self.s.width, self.s.height)
            if density <= self.cfg.min_histogram_density:
                return False
            self.ref_frame = frame
            return False
        f1, f2 = self.ref_frame, frame
        cfg = self.cfg
        s = self.s

        i1, i2 = self._guided_match(f1, f2)
        if len(i1) < cfg.min_matches:
            # scene changed too much: restart from the current frame (if it
            # passes the same coverage gate as any first frame)
            if len(i1) < cfg.min_matches // 2:
                self.ref_frame = None
                return self.try_initialize(tracker, frame)
            return False

        flow = np.linalg.norm(f1.uv[i1] - f2.uv[i2], axis=1)
        if np.median(flow) < cfg.min_median_flow_px:
            return False  # not enough baseline yet; keep waiting

        # normalized coordinates
        def norm(uv):
            return np.stack(
                [(uv[:, 0] - s.cx) / s.fx, (uv[:, 1] - s.cy) / s.fy], axis=1
            )

        xn1 = norm(f1.uv[i1])
        xn2 = norm(f2.uv[i2])
        th = (cfg.ransac_threshold_px / s.fx) ** 2

        # pad the match count to a power-of-two bucket: every stage below
        # (both RANSACs, pose recovery, the 2-view BA) shapes on it, and
        # the count varies per attempted frame pair; buckets keep the
        # shapes few
        n_raw = len(i1)
        nb = 64
        while nb < n_raw:
            nb *= 2
        xn1p = np.zeros((nb, 2), dtype=np.float32)
        xn2p = np.zeros((nb, 2), dtype=np.float32)
        xn1p[:n_raw] = xn1
        xn2p[:n_raw] = xn2
        xn1, xn2 = xn1p, xn2p

        self.n_attempts += 1
        self.key, k1, k2 = prng.split(self.key, 3)
        mask = torch.from_numpy(np.arange(nb) < n_raw)
        xn1t = torch.from_numpy(xn1)
        xn2t = torch.from_numpy(xn2)
        E, e_inl, n_e = essential_ransac(
            xn1t, xn2t, mask, k1, n_hypotheses=256, threshold=th)
        n_e = int(n_e)
        if n_e < cfg.min_inliers:
            return False

        # planar/rotation degeneracy: homography explains the motion
        _, _, n_h = homography_ransac(
            xn1t, xn2t, mask, k2, n_hypotheses=128, threshold=2.0 * th)
        if int(n_h) > cfg.max_homography_ratio * n_e:
            return False

        # pose of frame2 relative to frame1 (frame1 = world origin):
        # recover_pose treats the first coordinate set's camera as the world
        T2, X, good = recover_pose_from_essential(E, xn1t, xn2t, e_inl)
        T2 = T2.numpy().astype(np.float64)
        X = X.numpy().astype(np.float64)
        good = good.numpy()
        if good.sum() < cfg.min_inliers:
            return False

        # median parallax angle gate
        c2 = -T2[:3, :3].T @ T2[:3, 3]
        r1 = X[good]
        r2 = X[good] - c2
        cosang = np.sum(r1 * r2, axis=1) / np.maximum(
            np.linalg.norm(r1, axis=1) * np.linalg.norm(r2, axis=1), 1e-12
        )
        med_angle = np.degrees(np.arccos(np.clip(np.median(cosang), -1, 1)))
        if med_angle < cfg.min_median_angle_deg:
            return False

        # ---- two-view BA refinement ----
        T2, X, good = self._two_view_ba(xn1, xn2, T2, X, good, s)
        if good.sum() < cfg.min_inliers:
            return False

        # inlier-coverage degeneracy gate (checkHistogram,
        # MonoInitializer.cpp:413-457, applied at :559-567): the surviving
        # matches must cover enough of BOTH images, or the bootstrap
        # geometry is dominated by one structure patch
        binratio = min(
            feature_histogram_density(f1.uv[i1[good[:n_raw]]],
                                      s.width, s.height),
            feature_histogram_density(f2.uv[i2[good[:n_raw]]],
                                      s.width, s.height),
        )
        if binratio < cfg.min_histogram_density:
            return False

        # ---- median-depth normalization (target_scale = 3) ----
        med_depth = np.median(X[good][:, 2])
        if med_depth <= 1e-6:
            return False
        scale = cfg.target_scale / med_depth
        X = X * scale
        T2[:3, 3] *= scale

        self._create_map(tracker, f1, f2, i1, i2,
                         T2, X[:n_raw], good[:n_raw])
        return True

    # ------------------------------------------------------------------

    def _two_view_ba(self, xn1, xn2, T2, X, good, s):
        """Joint refinement of T2 + points via the dense-Schur BA on a
        2-camera problem (TwoViewReconstruction's bundle-adjust analog)."""
        n = len(xn1)
        P = n
        uv1 = np.stack([xn1[:, 0] * s.fx + s.cx, xn1[:, 1] * s.fy + s.cy], 1)
        uv2 = np.stack([xn2[:, 0] * s.fx + s.cx, xn2[:, 1] * s.fy + s.cy], 1)
        obs_cam = np.tile(np.array([0, 1], dtype=np.int32), (P, 1))
        obs_uv = np.stack([uv1, uv2], axis=1)
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        problem = BA.BAProblem(
            cam_pose=up(np.stack([np.eye(4), T2]), np.float32),
            cam_fixed=up([True, False], bool),
            cam_valid=up([True, True], bool),
            points=up(X, np.float32),
            point_valid=up(good, bool),
            obs_cam=up(obs_cam, np.int32),
            obs_uv=up(obs_uv, np.float32),
            obs_right=torch.full((P, 2), -1.0, dtype=torch.float32,
                                 device=dev),
            obs_weight=torch.ones((P, 2), dtype=torch.float32, device=dev),
            obs_valid=up(np.tile(good[:, None], (1, 2)), bool),
            **BA.empty_rpc(dev),
        )
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cam_pose, points, _ = BA.solve_ba(problem, self.cam, zero,
                                          iterations=5)
        out = BA.classify_outliers(problem, self.cam, zero, cam_pose,
                                   points).cpu().numpy()
        good = good & ~out.any(axis=1)
        T2 = cam_pose[1].cpu().numpy().astype(np.float64)
        X = points.cpu().numpy().astype(np.float64)
        # positive-depth re-check after refinement
        z1 = X[:, 2]
        z2 = (X @ T2[:3, :3].T + T2[:3, 3])[:, 2]
        good = good & (z1 > 1e-3) & (z2 > 1e-3)
        return T2, X, good

    # ------------------------------------------------------------------

    def _create_map(self, tracker, f1, f2, i1, i2, T2, X, good):
        """InitializeMap (MonoInitializer.cpp:278-393): two keyframes +
        triangulated points."""
        smap = tracker.map
        f1.pose_cw = np.eye(4)
        f1.matches = np.full(f1.n, -1, dtype=np.int64)
        f1.outlier = np.zeros(f1.n, dtype=bool)
        f2.pose_cw = T2.copy()
        f2.matches = np.full(f2.n, -1, dtype=np.int64)
        f2.outlier = np.zeros(f2.n, dtype=bool)

        kf1 = smap.allocate_keyframe(f1)
        kf2 = smap.allocate_keyframe(f2)
        smap.kf_prev[kf2] = kf1
        smap.kf_next[kf1] = kf2
        smap.kf_parent[kf2] = kf1

        for j in np.nonzero(good)[0]:
            a, b = int(i1[j]), int(i2[j])
            wp = X[j]
            normal = -wp / max(np.linalg.norm(wp), 1e-9)
            pt = smap.allocate_point(
                wp, f1.descriptors[a], kf1, float(np.linalg.norm(wp)),
                int(f1.octave[a]), normal,
            )
            smap.add_observation(kf1, a, pt)
            smap.add_observation(kf2, b, pt)
            f1.matches[a] = pt
            f2.matches[b] = pt

        for kf in (kf1, kf2):
            smap.compute_median_depth(kf)
            for pt in smap.keyframe_points(kf):
                smap.update_point_descriptor_and_normal(int(pt))

        f1.is_keyframe = True
        f2.is_keyframe = True
        f1.ref_kf = kf1
        f2.ref_kf = kf2
        f1.rel_to_ref = np.eye(4)
        f2.rel_to_ref = np.eye(4)
        f1.ref_frame_id = int(f1.frame_id)
        f2.ref_frame_id = int(f2.frame_id)
        tracker.trajectory.append(f1)  # f2 is appended by process_frame
        tracker.last_kf = kf2
        tracker.velocity = np.eye(4)
        tracker.last_tracked_frame = f2
        if tracker.local_mapper is not None:
            tracker.local_mapper.on_map_initialized(kf2)
            if tracker.local_mapper.lba is not None:
                tracker.local_mapper.lba.run(kf2)
        self.ref_frame = None
