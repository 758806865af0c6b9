"""SlamSystem: module construction, per-frame entry, trajectories, ATE.

Counterpart of ``snakeslam_tpu/system/slam.py`` for stereo / RGB-D input on
one ``device``: the map, the tracker, the local mapper with its keyframe
cycle (triangulation, neighbour fusion, local BA) and the keyframe-
reduction back-ends behind delayed queues (simplification, delay 8; the
deferred mapper, delay 9), built as the JAX package builds them.  The BoW
vocabulary, keyframe database, loop closing and relocalization arrive with
the system glue of ROADMAP.md queue A, step 9, and so do ``run`` and
``finalize`` (global BA).  Driven as
``WindowedRunner(SlamSystem(settings, device), window).run(frames)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core import trajectory as traj
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.mapping.local_mapping import LocalMapper
from snakeslam_tpu_torch.optim.deferred_mapper import DeferredMapper
from snakeslam_tpu_torch.optim.lba import LocalBA
from snakeslam_tpu_torch.optim.simplification import Simplification
from snakeslam_tpu_torch.system.queues import DelayedQueue
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.system.stats import PerformanceStats
from snakeslam_tpu_torch.tracking.tracker import Tracker


def _check_settings(s: Settings):
    unported = [
        (s.input_type == InputType.Mono, "monocular input",
         "ROADMAP.md queue A, step 12"),
        (s.enable_imu, "enable_imu", "ROADMAP.md queue A, step 13"),
        (s.async_mode, "async_mode", "ROADMAP.md queue A, step 15"),
        (s.async_lba, "async_lba", "ROADMAP.md queue A, step 15"),
        (s.n_devices > 1, "n_devices > 1", "ROADMAP.md queue A, step 16"),
    ]
    for bad, what, step in unported:
        if bad:
            raise NotImplementedError(
                f"SlamSystem: {what} is not ported yet ({step})")


def _quat(R: np.ndarray) -> np.ndarray:
    return lie.rotmat_to_quat(torch.as_tensor(R)).numpy()


class _QueueBackend:
    """A local-mapper back-end that feeds a delayed queue: add the
    keyframe, then advance the queue's horizon to it."""

    def __init__(self, queue: DelayedQueue):
        self.queue = queue

    def add(self, kf: int):
        self.queue.add(kf)
        self.queue.update(kf)


class SlamSystem:
    def __init__(self, settings: Settings, device):
        _check_settings(settings)
        self.s = settings
        self.device = torch.device(device)
        self.map = SlamMap(settings.max_keyframes, settings.max_points,
                           settings.feature_slots)
        self.lba = LocalBA(settings, self.map, self.device)

        # simplification + deferred mapping behind delayed queues
        # (reference delays: simplification 8, deferred mapper 9)
        self.simplification = Simplification(settings, self.map)
        self.deferred_mapper = DeferredMapper(settings, self.map)
        self._simp_queue = DelayedQueue(self.simplification.add, delay=8,
                                        name="simplification")
        self._deferred_queue = DelayedQueue(self.deferred_mapper.add, delay=9,
                                            name="deferred")

        self.local_mapper = LocalMapper(
            settings, self.map, self.device, lba=self.lba,
            backends=[_QueueBackend(self._simp_queue),
                      _QueueBackend(self._deferred_queue)],
        )
        self.deferred_mapper.map_searcher = self.local_mapper.map_searcher
        self.deferred_mapper.local_mapper = self.local_mapper
        self.tracker = Tracker(settings, self.map, self.device,
                               local_mapper=self.local_mapper)
        self.stats = PerformanceStats()
        self.n_frames = 0

    def process_frame(self, frame: FrameData):
        with self.stats.timer("Tracking"):
            with self.map.lock:
                st = self.tracker.process_frame(frame)
        self.n_frames += 1
        return st

    def run(self, frames):
        raise NotImplementedError(
            "SlamSystem.run: the dataset loop ends in the global BA passes, "
            "ported with the system glue (ROADMAP.md queue A, step 9); "
            "drive the slice with WindowedRunner(system, window).run(frames)")

    def finalize(self, gba_iterations: int = 5, vi_alternations: int = 10):
        raise NotImplementedError(
            "SlamSystem.finalize: global BA is ported with the system glue "
            "(ROADMAP.md queue A, step 9)")

    # ------------------------------------------------------------------
    # trajectory export (TUM format)
    # ------------------------------------------------------------------

    def frame_pose_global(self, f) -> np.ndarray | None:
        """A tracked frame's current global pose, composed through its
        reference keyframe while that keyframe still holds the same source
        frame; through the recorded anchor chain of culled references."""
        if f.pose_cw is None:
            return None
        if f.rel_to_ref is None:
            return f.pose_cw
        rel = f.rel_to_ref
        r, rfid = f.ref_kf, f.ref_frame_id
        for _ in range(64):
            if (0 <= r < self.map.max_keyframes and self.map.kf_valid[r]
                    and self.map.kf_frame_id[r] == rfid):
                return rel @ self.map.kf_pose[r]
            hop = self.map.erased_kf_rel.get(int(rfid))
            if hop is None:
                return f.pose_cw
            a, afid, arel = hop
            rel = rel @ arel
            r, rfid = a, afid
        return f.pose_cw

    def frame_trajectory(self):
        """(timestamps, positions, quats_wxyz) of all tracked frames, camera
        center in world coordinates."""
        ts, pos, quat = [], [], []
        for f in self.tracker.trajectory:
            pose = self.frame_pose_global(f)
            if pose is None:
                continue
            Twc = np.linalg.inv(pose)
            ts.append(f.timestamp)
            pos.append(Twc[:3, 3])
            quat.append(_quat(Twc[:3, :3]))
        return np.array(ts), np.array(pos), np.array(quat)

    def keyframe_trajectory(self):
        ks = self.map.valid_keyframes()
        ks = ks[np.argsort(self.map.kf_timestamp[ks])]
        ts, pos, quat = [], [], []
        for k in ks:
            Twc = np.linalg.inv(self.map.kf_pose[k])
            ts.append(self.map.kf_timestamp[k])
            pos.append(Twc[:3, 3])
            quat.append(_quat(Twc[:3, :3]))
        return np.array(ts), np.array(pos), np.array(quat)

    def write_trajectories(self, out_dir: str | Path):
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        prefix = self.s.out_file_prefix
        ts, pos, quat = self.frame_trajectory()
        if len(ts):
            traj.write_tum(out_dir / f"{prefix}_frames_ba.tum", ts, pos, quat)
        ts, pos, quat = self.keyframe_trajectory()
        if len(ts):
            traj.write_tum(out_dir / f"{prefix}_keyframes_ba.tum", ts, pos, quat)

    def ate_against_gt(self, with_scale: bool = True):
        """ATE vs the ground-truth poses carried by the frames (eval only)."""
        est, gt = [], []
        for f in self.tracker.trajectory:
            pose = self.frame_pose_global(f)
            if pose is None or f.gt_pose_cw is None:
                continue
            est.append(np.linalg.inv(pose)[:3, 3])
            gt.append(np.linalg.inv(f.gt_pose_cw)[:3, 3])
        if len(est) < 3:
            return float("nan"), 1.0, 0
        rmse, scale = traj.ate_rmse(np.array(est), np.array(gt),
                                    with_scale=with_scale)
        return rmse, scale, len(est)
