"""Per-frame tracking: state machine, prediction, coarse/fine stages.

Counterpart of ``snakeslam_tpu/tracking/tracker.py``: states
NOT_INITIALIZED / OK / RECOVERING / LOST, single-frame depth initialization
(stereo, RGB-D) or the two-frame monocular bootstrap
(tracking/mono_init.py), constant-velocity prediction fused with the gyro
preintegration once the IMU solver has a gyro bias, the coarse -> fine
per-frame pipeline (models/tracking_step.py), brute-force recovery (knn +
PnP RANSAC), BoW relocalization once LOST, the keyframe decision and the
lost-tracking policy.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.map.slam_map import (FrameData, SlamMap,
                                              transform_pose_cw)
from snakeslam_tpu_torch.models.tracking_step import coarse_step, fine_step
from snakeslam_tpu_torch.ops.imu import preintegrate_np
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.tracking.mono_init import MonoInitializer
from snakeslam_tpu_torch.tracking.staging import pad_frame_features


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECOVERING = 2
    LOST = 3


@dataclass
class TrackStats:
    n_coarse_matches: int = 0
    n_coarse_inliers: int = 0
    n_fine_inliers: int = 0
    state: TrackingState = TrackingState.NOT_INITIALIZED
    made_keyframe: bool = False


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


class Tracker:
    def __init__(self, settings: Settings, smap: SlamMap, device,
                 local_mapper=None, imu_solver=None, relocalizer=None):
        self.s = settings
        self.map = smap
        self.device = torch.device(device)
        self.local_mapper = local_mapper
        self.imu_solver = imu_solver
        self.relocalizer = relocalizer
        self.state = TrackingState.NOT_INITIALIZED
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)

        self.last_frame: FrameData | None = None
        self.last_tracked_frame: FrameData | None = None
        self.last_kf: int = -1
        self.velocity = np.eye(4)   # camera-space relative motion model
        self.recover_frames = 0

        dev = self.device
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=dev)
        self.bf = _scalar(settings.bf, dev)
        margin = 0.0
        self.bounds = torch.tensor(
            [margin, margin, settings.width - margin,
             settings.height - margin], dtype=torch.float32, device=dev)
        self.scales = torch.as_tensor(self.pyramid.scales, device=dev)
        self.log_sf = _scalar(self.pyramid.log_scale_factor, dev)
        self.is_mono = settings.input_type == InputType.Mono
        self.coarse_radius = _scalar(15.0 if self.is_mono else 10.0, dev)
        self.fine_th = _scalar(5.0 if self.is_mono else 4.0, dev)
        self.zero = _scalar(0.0, dev)
        # brute-force recovery's RANSAC key, made at its first use as the
        # JAX tracker makes it
        self._bf_key = None

        self.trajectory: list[FrameData] = []
        smap.on_transform.append(self._on_map_transform)
        self._fine_cache_state = -1
        # (snapshot, slot->point ids, pt_alloc_gen at snapshot time)
        self._fine_cache = (None, None, None)
        self.mirror = smap.device_mirror(dev)
        self.mono_initializer = MonoInitializer(
            settings, dev, quality=settings.initialization_quality,
            seed=settings.random_seed) if self.is_mono else None

    def _on_map_transform(self, s, R, t):
        """Rebase tracker state after a whole-map Sim3 (the reference's
        equivalent is StatePredictor::Rescale + relative pose storage,
        StatePredictor.cpp:206-216)."""
        for f in self.trajectory:
            if f.pose_cw is not None:
                f.pose_cw = transform_pose_cw(f.pose_cw, s, R, t)
            if f.rel_to_ref is not None and s != 1.0:
                # T and T_ref both rebase under the similarity; the relative
                # rotation is invariant and the translation scales by s
                f.rel_to_ref = f.rel_to_ref.copy()
                f.rel_to_ref[:3, 3] *= s
        f = self.last_frame
        if (f is not None and f.pose_cw is not None
                and not any(f is g for g in self.trajectory)):
            f.pose_cw = transform_pose_cw(f.pose_cw, s, R, t)
        self.velocity = self.velocity.copy()
        self.velocity[:3, 3] *= s  # relative rotation invariant; trans scales

    def _reset(self):
        """Back to NOT_INITIALIZED on an emptied map; the IMU solver's
        edges are keyed by keyframe ids the pool will hand out again."""
        self.map.clear()
        if self.imu_solver is not None:
            self.imu_solver.clear()
        self.state = TrackingState.NOT_INITIALIZED
        self.last_kf = -1
        self.last_frame = None
        self.last_tracked_frame = None
        self.velocity = np.eye(4)

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------

    def process_frame(self, frame: FrameData) -> TrackStats:
        stats = TrackStats(state=self.state)
        if self.imu_solver is not None:
            self.imu_solver.add_frame_samples(frame)
            if self.imu_solver.map_reset_requested:
                # VI init declared the map inconsistent: full reset
                # (ImuStateSolver.cpp:277-280)
                self._reset()
        if (self.state == TrackingState.LOST
                and self.relocalizer is not None
                and self.relocalizer.try_relocalize(frame)):
            # BoW relocalization (TrackingCoarse.cpp:514-539)
            self.state = TrackingState.OK
            self.recover_frames = 0
            self.velocity = np.eye(4)
            self.last_kf = frame.ref_kf
            self.last_tracked_frame = frame
            self.last_frame = frame
            self.trajectory.append(frame)
            stats.state = self.state
            return stats
        if self.state == TrackingState.NOT_INITIALIZED:
            ok = self._initialize(frame)
            if ok:
                self.state = TrackingState.OK
                stats.made_keyframe = True
            stats.state = self.state
            self.last_frame = frame
            if ok:
                self.last_tracked_frame = frame
                self.trajectory.append(frame)
            return stats

        # prediction (StatePredictor analog: constant-velocity motion model
        # fused with the gyro preintegration, StatePredictor.cpp:18-102)
        T_pred = self.velocity @ self.last_frame.pose_cw if (
            self.last_frame is not None and self.last_frame.pose_cw is not None
        ) else self.map.kf_pose[self.last_kf].copy()
        prior_w_rot = 0.0
        if (self.imu_solver is not None and self.imu_solver.gyro_initialized
                and frame.imu_omega is not None and len(frame.imu_omega)
                and self.last_frame is not None
                and self.last_frame.pose_cw is not None):
            pre = preintegrate_np(
                frame.imu_omega, frame.imu_acc, frame.imu_dt,
                self.imu_solver.bg, self.imu_solver.ba)
            # body == camera: R_cw_new = dR^T @ R_cw_last
            T_pred = T_pred.copy()
            T_pred[:3, :3] = pre.dR.T @ self.last_frame.pose_cw[:3, :3]
            prior_w_rot = self.s.weight_gyro_tracking / max(float(pre.dt),
                                                            1e-3)

        ok = self._track(frame, T_pred, stats, prior_w_rot=prior_w_rot)
        if ok:
            self.state = TrackingState.OK
            self.recover_frames = 0
            if (self.last_tracked_frame is not None
                    and self.last_tracked_frame.pose_cw is not None
                    and frame.frame_id - self.last_tracked_frame.frame_id == 1):
                self.velocity = frame.pose_cw @ np.linalg.inv(
                    self.last_tracked_frame.pose_cw)
            self.last_tracked_frame = frame
            self.trajectory.append(frame)

            with tracer.span("tracker.kf_decision"):
                need, reason = self._need_new_keyframe(frame)
            if need and self.local_mapper is not None:
                kf = self.local_mapper.insert_keyframe(frame, self.last_kf)
                if kf >= 0:
                    self.last_kf = kf
                    stats.made_keyframe = True
        else:
            self._handle_loss(frame)
        stats.state = self.state
        self.last_frame = frame
        return stats

    # ------------------------------------------------------------------
    # initialization (RGB-D / stereo single-frame bootstrap)
    # ------------------------------------------------------------------

    def _initialize(self, frame: FrameData) -> bool:
        """Depth input needs >= 180 depth features and unprojects them to
        map points; monocular input goes through the two-frame
        initializer."""
        if self.is_mono:
            return self.mono_initializer.try_initialize(self, frame)
        has_depth = frame.depth > 0
        if has_depth.sum() < 180:
            return False
        frame.pose_cw = np.eye(4)
        frame.matches = np.full(frame.n, -1, dtype=np.int64)
        frame.outlier = np.zeros(frame.n, dtype=bool)
        kf = self.map.allocate_keyframe(frame)
        fx, fy, cx, cy = self.s.fx, self.s.fy, self.s.cx, self.s.cy
        for i in np.nonzero(has_depth)[0]:
            z = frame.depth[i]
            wp = np.array([
                (frame.uv[i, 0] - cx) / fx * z,
                (frame.uv[i, 1] - cy) / fy * z,
                z,
            ])
            normal = -wp / max(np.linalg.norm(wp), 1e-9)
            pt = self.map.allocate_point(
                wp, frame.descriptors[i], kf, float(np.linalg.norm(wp)),
                int(frame.octave[i]), normal,
            )
            self.map.add_observation(kf, int(i), pt)
            frame.matches[i] = pt
        self.map.compute_median_depth(kf)
        frame.is_keyframe = True
        frame.ref_kf = kf
        frame.rel_to_ref = np.eye(4)
        frame.ref_frame_id = int(frame.frame_id)
        self.last_kf = kf
        self.velocity = np.eye(4)
        if self.local_mapper is not None:
            self.local_mapper.on_map_initialized(kf)
        return True

    # ------------------------------------------------------------------
    # coarse + fine tracking
    # ------------------------------------------------------------------

    def _coarse_local_map(self):
        """Points of the last frame's matches + the last KF's observations,
        with octave/angle payload from their source keypoints."""
        ids, angles, octaves = [], [], []
        if self.last_frame is not None and self.last_frame.matches is not None:
            m = self.last_frame.matches
            sel = np.nonzero((m >= 0) & self.map.pt_valid[np.maximum(m, 0)])[0]
            ids.append(m[sel])
            angles.append(self.last_frame.angle[sel])
            octaves.append(self.last_frame.octave[sel])
        if self.last_kf >= 0:
            kf = self.last_kf
            n = self.map.kf_n_feat[kf]
            feats = np.nonzero(self.map.kf_obs[kf, :n] >= 0)[0]
            pts = self.map.kf_obs[kf, feats]
            ok = self.map.pt_valid[pts]
            ids.append(pts[ok])
            angles.append(self.map.kf_feat_angle[kf, feats[ok]])
            octaves.append(self.map.kf_feat_octave[kf, feats[ok]].astype(np.int32))
        if not ids:
            return None, None
        ids = np.concatenate(ids)
        angles = np.concatenate(angles).astype(np.float32)
        octaves = np.concatenate(octaves).astype(np.int32)
        ids, first = np.unique(ids, return_index=True)
        return self.mirror.gather(ids, self.s.feature_slots * 2,
                                  angles=angles[first], octaves=octaves[first])

    def _fine_local_map(self, matched_ids: np.ndarray, n_slots=None):
        """Local keyframes = observers of the matched points, ranked by
        count, plus seeded exploration of further covisible keyframes;
        then their points.  ``n_slots`` pads the snapshot (None: the
        configured maximum)."""
        if len(matched_ids) == 0:
            return None, None
        obs_kfs = self.map.pt_obs_kf[matched_ids].ravel()
        obs_kfs = obs_kfs[obs_kfs >= 0]
        counts = np.bincount(obs_kfs, minlength=self.map.max_keyframes)
        order = np.argsort(-counts)
        local_kfs = [int(k) for k in order[:15] if counts[k] > 0]
        rest = [int(k) for k in order[15:] if counts[k] > 0]

        # seeded exploration: a hash of (epoch, kf id) is the coin
        self._fine_epoch = getattr(self, "_fine_epoch", 0) + 1
        epoch = self._fine_epoch
        explore = getattr(self.s, "fine_explore", True)

        def coin(k, salt, prob):
            if not explore:
                return False
            h = (k * 2654435761 + epoch * 40503 + salt * 97) & 0xFFFFFFFF
            return (h % 65536) / 65536.0 < prob

        extra_direct, second_chance = [], []
        if rest:
            prob = 5.0 / len(rest)
            for k in rest:
                (extra_direct if coin(k, 1, prob)
                 else second_chance).append(k)
        chosen = local_kfs + extra_direct
        in_local = set(chosen)
        indirect = list(second_chance)
        for k in chosen:
            ids, w = self.map.covisible_keyframes(k, min_weight=15)
            for nb in ids[:5]:
                nb = int(nb)
                if nb not in in_local:
                    in_local.add(nb)
                    indirect.append(nb)
        extra_indirect = []
        if indirect:
            prob_ind = 5.0 / len(indirect)
            extra_indirect = [k for k in indirect if coin(k, 2, prob_ind)]
        all_kfs = list(dict.fromkeys(chosen + extra_indirect))
        pts = [self.map.keyframe_points(int(k)) for k in all_kfs]
        if not pts:
            return None, None
        ids = np.unique(np.concatenate(pts))
        ids = ids[self.map.pt_valid[ids]]
        if n_slots is None:
            n_slots = self.s.local_map_slots
        if len(ids) > n_slots:
            ids = ids[:n_slots]
        return self.mirror.gather(ids, n_slots)

    def _track_brute_force(self, frame: FrameData, min_inliers: int = 15):
        """Descriptor knn vs the reference KF's points + PnP RANSAC.

        Returns (T (4,4) tensor, matched_sel (n,) bool, matched_pts global
        ids) or None."""
        from snakeslam_tpu_torch.ops.descriptors import unpack_bits_np
        from snakeslam_tpu_torch.ops.matching import knn2_ratio_match_np
        from snakeslam_tpu_torch.ops.pose_solver import pnp_refine_np

        smap = self.map
        kf = self.last_kf
        if kf < 0 or not smap.kf_valid[kf]:
            return None
        pts = smap.keyframe_points(kf)
        pts = pts[smap.pt_valid[pts]]
        if len(pts) < min_inliers:
            return None
        idx, dist = knn2_ratio_match_np(
            unpack_bits_np(frame.descriptors), smap.pt_bits[pts],
            ratio=0.8, max_dist=64, device=self.device,
        )
        sel = idx >= 0
        if sel.sum() < min_inliers:
            return None
        obs_pts = smap.pt_pos[pts[idx[sel]]]
        obs_uv = frame.uv[sel]
        if self._bf_key is None:
            self._bf_key = prng.PRNGKey(self.s.random_seed + 29)
        self._bf_key, sub = prng.split(self._bf_key)
        n0, T, inlier, n_inl = pnp_refine_np(
            obs_pts, obs_uv, self.cam, self.bf, sub, n_hypotheses=256)
        if n0 < min_inliers or n_inl < min_inliers:
            return None
        matched_sel = np.zeros(frame.n, dtype=bool)
        sel_idx = np.nonzero(sel)[0]
        matched_sel[sel_idx[inlier]] = True
        matched_pts = pts[idx[sel]][inlier]
        return T, matched_sel, matched_pts

    def _track(self, frame: FrameData, T_pred: np.ndarray,
               stats: TrackStats, prior_w_rot: float = 0.0) -> bool:
        dev = self.device
        tracer.count("tracker.frames")
        w_rot = _scalar(prior_w_rot, dev) if prior_w_rot else self.zero
        with tracer.span("tracker.coarse_map"):
            lm_coarse, coarse_ids = self._coarse_local_map()
        if lm_coarse is None:
            return False
        with tracer.span("tracker.coarse"):
            feats = pad_frame_features(frame, self.s.feature_slots, dev)
            T_pred_t = torch.as_tensor(T_pred, dtype=torch.float32,
                                       device=dev)
            out = coarse_step(
                lm_coarse, feats, T_pred_t, self.cam, self.bf, self.bounds,
                self.scales, self.log_sf, self.coarse_radius, w_rot,
                self.zero,
            )
        Ns = self.s.feature_slots
        with tracer.span("tracker.wait"):
            packed = out["packed"].cpu().numpy()   # one device->host copy
        stats.n_coarse_matches = int(packed[16])
        stats.n_coarse_inliers = int(packed[17])
        if packed[18] > 0.5:
            T_coarse = out["T"]  # stays on the device for the fine step
            assign = packed[19:19 + Ns].astype(np.int64)[: frame.n]
            matched_sel = assign >= 0
            matched_pts = coarse_ids[assign[matched_sel]]
        else:
            # brute-force fallback vs the reference keyframe
            bf_out = self._track_brute_force(frame)
            if bf_out is None:
                return False
            T_coarse, matched_sel, matched_pts = bf_out
            stats.n_coarse_inliers = int(matched_sel.sum())

        # the fine snapshot is reused until the map generation moves
        if self.map.state == self._fine_cache_state:
            lm_fine, fine_ids, _ = self._fine_cache
        else:
            tracer.count("tracker.fine_map_rebuilds")
            with tracer.span("tracker.fine_map"):
                lm_fine, fine_ids = self._fine_local_map(
                    np.unique(matched_pts))
                if lm_fine is not None:
                    self._fine_cache = (
                        lm_fine, fine_ids,
                        self.map.pt_alloc_gen[fine_ids].copy())
                    self._fine_cache_state = self.map.state
        if lm_fine is None:
            return False
        with tracer.span("tracker.fine"):
            coarse_matched_pad = np.zeros(Ns, dtype=bool)
            coarse_matched_pad[: frame.n] = matched_sel
            coarse_pos = np.zeros((Ns, 3), dtype=np.float32)
            coarse_pos[np.nonzero(coarse_matched_pad)[0]] = self.map.pt_pos[
                matched_pts]
            fout = fine_step(
                lm_fine, feats, T_coarse,
                torch.from_numpy(coarse_pos).to(dev),
                torch.from_numpy(coarse_matched_pad).to(dev),
                self.cam, self.bf, self.bounds, self.scales, self.log_sf,
                self.fine_th, T_pred_t, w_rot, self.zero,
            )
        P = lm_fine.position.shape[0]
        with tracer.span("tracker.wait"):
            fpacked = fout["packed"].cpu().numpy()
        n_inl = int(fpacked[16])
        stats.n_fine_inliers = n_inl
        if n_inl < 25:
            return False
        with tracer.span("tracker.post"):
            frame.pose_cw = fpacked[:16].reshape(4, 4).astype(np.float64)
            off = 17
            fine_assign = fpacked[off:off + Ns].astype(np.int64)[: frame.n]
            off += Ns
            inlier = fpacked[off:off + Ns][: frame.n] > 0.5
            off += Ns
            visible_full = fpacked[off:off + P] > 0.5
            matches = np.full(frame.n, -1, dtype=np.int64)
            coarse_global = np.full(frame.n, -1, dtype=np.int64)
            coarse_global[matched_sel] = matched_pts
            keep_coarse = matched_sel & inlier
            matches[keep_coarse] = coarse_global[keep_coarse]
            keep_fine = (fine_assign >= 0) & inlier & ~keep_coarse
            matches[keep_fine] = fine_ids[fine_assign[keep_fine]]
            frame.matches = matches
            frame.outlier = np.zeros(frame.n, dtype=bool)
            frame.ref_kf = self.last_kf
            frame.capture_rel(self.map.kf_pose[self.last_kf],
                              self.map.kf_frame_id[self.last_kf])

            # found/visible statistics: every final inlier match counts as
            # found
            visible = visible_full[: len(fine_ids)]
            matched_ids = matches[matches >= 0]
            visible_ids = np.union1d(fine_ids[visible], matched_ids)
            self.map.pt_visible[visible_ids] += 1
            self.map.pt_found[np.unique(matched_ids)] += 1
        return True

    # ------------------------------------------------------------------
    # keyframe decision (KeyframeDecision.cpp:18-180)
    # ------------------------------------------------------------------

    def _need_new_keyframe(self, frame: FrameData):
        smap = self.map
        current_matches = int((frame.matches >= 0).sum())
        if self.s.input_type == InputType.Stereo:
            m = frame.matches >= 0
            close = m & (frame.depth > 0) & (frame.depth <= self.s.th_depth)
            non_close = m & ~close
            if close.sum() < 90 and non_close.sum() > 60:
                return True, "Low Stereo"
            current_matches = current_matches - int(non_close.sum())

        kf = self.last_kf
        kf_pts = smap.keyframe_points(kf)
        min_obs = 2 if smap.n_keyframes <= 2 else 3
        last_kf_matches = max(int((smap.pt_n_obs[kf_pts] >= min_obs).sum()), 1)
        target_ratio = current_matches / self.s.kfi_target_matches
        target_kf_ratio = current_matches / last_kf_matches

        if current_matches < 50:
            quality = "SUPER_BAD"
        elif current_matches < 60 or target_ratio < 0.5 or target_kf_ratio < 0.6:
            quality = "BAD"
        elif target_ratio >= 1.3:
            quality = "VERY_GOOD"
        elif target_ratio >= 0.8 or target_kf_ratio > 2.0:
            quality = "GOOD"
        else:
            quality = "MEDIUM"

        num_frames_since_kf = frame.frame_id - smap.kf_frame_id[kf]
        if frame.timestamp - smap.kf_timestamp[kf] >= 0.5:
            return True, "Time"
        if quality == "SUPER_BAD":
            return False, "Super Bad"
        if quality == "VERY_GOOD":
            return False, "Very Good"

        med_depth = smap.kf_median_depth[kf] or smap.compute_median_depth(kf)
        cam_pos = -frame.pose_cw[:3, :3].T @ frame.pose_cw[:3, 3]
        kf_T = smap.kf_pose[kf]
        kf_pos = -kf_T[:3, :3].T @ kf_T[:3, 3]
        baseline = np.linalg.norm(cam_pos - kf_pos)
        translation_angle = np.degrees(
            np.arctan2(baseline / 2.0, max(med_depth, 1e-6)))
        dir1 = frame.pose_cw[:3, :3].T @ np.array([0, 0, 1.0])
        dir2 = kf_T[:3, :3].T @ np.array([0, 0, 1.0])
        rotation_angle = np.degrees(np.arccos(np.clip(dir1 @ dir2, -1.0, 1.0)))

        if num_frames_since_kf > 30 and translation_angle > 0.5:
            return True, "Time"
        if quality == "GOOD":
            return False, "Good"
        if translation_angle > 1 or rotation_angle > 15:
            return True, "Good Angle"
        if (translation_angle > 1 or rotation_angle > 10) and quality == "BAD":
            return True, "Self Rotation"
        return False, "Default"

    # ------------------------------------------------------------------
    # loss handling (Tracking.cpp:200-244)
    # ------------------------------------------------------------------

    def _handle_loss(self, frame: FrameData):
        if self.map.n_keyframes < self.s.reloc_min_keyframes:
            # early loss: clear the map and re-initialize
            self._reset()
            return
        recent = self.map.valid_keyframes()[-5:]
        self.map.kf_cull_factor[recent] = 2.0
        self.recover_frames += 1
        self.state = (TrackingState.RECOVERING
                      if self.recover_frames <= 3 else TrackingState.LOST)
