"""SlamSystem: module construction, the run loop, end-of-run passes,
trajectories, ATE.

Counterpart of ``snakeslam_tpu/system/slam.py`` for monocular, stereo and
RGB-D input on one ``device``: the map, the IMU state solver (with
``enable_imu``), the BoW vocabulary and keyframe database, loop
closing (with its own global BA) and relocalization, the tracker, the local
mapper with its keyframe cycle (triangulation, neighbour fusion, local BA)
and, behind it, loop closing first and then the keyframe-reduction
back-ends behind delayed queues (simplification, delay 8; the deferred
mapper, delay 9), built as the JAX package builds them.  ``run`` drives a
frame iterable frame by frame and ends in ``finalize`` (the end-of-run
mitigation, global BA passes, outlier removal, rematch and realign); the
fast path is ``WindowedRunner(SlamSystem(settings, device), window).run(
frames)`` followed by ``finalize()``.

With ``n_devices > 1`` every global BA (the loop correction's,
``finalize``'s and the IMU solver's stages) runs sharded over a mesh of
that many shards (``parallel/multichip.py``).

``async_mode`` runs the front-end on a producer thread (system/pipeline.py)
and the delayed back-end queues on worker threads, each queue's work under
the map lock; ``async_lba`` runs the local BA on its own worker
(``AsyncLBA``).  ``frame_listeners`` are called with every processed frame
(the viewer's frame stream, viewer/export.py).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core import trajectory as traj
from snakeslam_tpu_torch.imu.state_solver import ImuStateSolver
from snakeslam_tpu_torch.loop.keyframe_database import KeyframeDatabase
from snakeslam_tpu_torch.loop.loop_closing import LoopClosing
from snakeslam_tpu_torch.loop.relocalization import Relocalizer
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.mapping.local_mapping import LocalMapper
from snakeslam_tpu_torch.ops import bow as BOW
from snakeslam_tpu_torch.optim.deferred_mapper import DeferredMapper
from snakeslam_tpu_torch.optim.gba import GlobalBA
from snakeslam_tpu_torch.optim.lba import LocalBA
from snakeslam_tpu_torch.optim.simplification import Simplification
from snakeslam_tpu_torch.system.pipeline import AsyncLBA, AsyncPipeline
from snakeslam_tpu_torch.system.queues import DelayedQueue
from snakeslam_tpu_torch.system.settings import Settings
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.tracking.tracker import Tracker


def load_vocabulary(settings: Settings) -> BOW.Vocabulary:
    """The configured vocabulary file, else the shipped one (trained on ORB
    descriptors of rendered synthetic scenes), else one trained on random
    bits."""
    voc_path = Path(settings.voc_file)
    if not voc_path.exists():
        shipped = (Path(__file__).resolve().parent.parent / "data"
                   / "orbvoc_synth.npz")
        if shipped.exists():
            voc_path = shipped
    if voc_path.exists() and voc_path.suffix == ".npz":
        return BOW.load_vocabulary_cached(voc_path)
    return BOW.random_vocabulary_cached(settings.random_seed)


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


def _under_lock(lock, fn):
    """``fn`` run under ``lock``: a queue's worker thread then mutates the
    map only between tracked frames."""

    def run(item):
        with lock:
            fn(item)

    return run


class SlamSystem:
    def __init__(self, settings: Settings, device):
        self.s = settings
        self.device = torch.device(device)
        self.map = SlamMap(settings.max_keyframes, settings.max_points,
                           settings.feature_slots)
        self.imu_solver = None
        if settings.enable_imu:
            self.imu_solver = ImuStateSolver(
                settings, self.map, self.device,
                gba=GlobalBA(settings, self.map, self.device))
        self.lba = LocalBA(settings, self.map, self.device,
                           imu_solver=self.imu_solver)

        # BoW vocabulary + keyframe database + loop closing + relocalization
        self.vocabulary = load_vocabulary(settings)
        self.database = KeyframeDatabase(self.vocabulary, self.map)
        self.loop_closing = LoopClosing(
            settings, self.map, self.database, self.device,
            gba=GlobalBA(settings, self.map, self.device))
        self.relocalizer = Relocalizer(settings, self.map, self.database,
                                       self.device)

        # simplification + deferred mapping behind delayed queues
        # (reference delays: simplification 8, deferred mapper 9)
        self.simplification = Simplification(settings, self.map,
                                             imu_solver=self.imu_solver)
        self.deferred_mapper = DeferredMapper(settings, self.map)
        par = bool(settings.async_mode)
        self._simp_queue = DelayedQueue(
            _under_lock(self.map.lock, self.simplification.add), delay=8,
            parallel=par, name="simplification")
        self._deferred_queue = DelayedQueue(
            _under_lock(self.map.lock, self.deferred_mapper.add), delay=9,
            parallel=par, name="deferred")
        self._async_lba = AsyncLBA(self.lba) if settings.async_lba else None

        self.local_mapper = LocalMapper(
            settings, self.map, self.device,
            lba=self._async_lba or self.lba,
            imu_solver=self.imu_solver,
            backends=[self.loop_closing,
                      _QueueBackend(self._simp_queue),
                      _QueueBackend(self._deferred_queue)],
        )
        self.deferred_mapper.map_searcher = self.local_mapper.map_searcher
        self.deferred_mapper.local_mapper = self.local_mapper
        self.tracker = Tracker(settings, self.map, self.device,
                               local_mapper=self.local_mapper,
                               imu_solver=self.imu_solver,
                               relocalizer=self.relocalizer)
        self.n_frames = 0
        self.frame_listeners: list = []   # per-frame viewer stream hooks

    def process_frame(self, frame: FrameData):
        with tracer.span("tracker.frame", frame.frame_id):
            with self.map.lock:
                st = self.tracker.process_frame(frame)
                self.map.stamp_matches(frame)
        self.n_frames += 1
        for cb in self.frame_listeners:
            cb(frame)
        return st

    def run(self, frames) -> float:
        """Drive a frame iterable through the pipeline frame by frame (the
        front-end on a producer thread in async mode), join the back-end
        workers, then ``finalize``.  Returns the wall time of the frames, in
        seconds (finalize excluded)."""
        t0 = time.perf_counter()
        if self.s.async_mode:
            AsyncPipeline(self, frames).run()
        else:
            for frame in frames:
                self.process_frame(frame)
        if self._async_lba is not None:
            self._async_lba.join()
        wall = time.perf_counter() - t0
        self.finalize()
        return wall

    def finalize(self, gba_iterations: int = 5, vi_alternations: int = 10):
        """End-of-run passes (System.cpp:167-215): the trailing-section
        mitigation, the delayed queues drained, full BA, then a second full
        BA or, once the IMU solver has gravity and scale, the final
        visual-inertial alternation (IterateBaImu: ``vi_alternations``
        rounds of IMU chain solve + full BA, a scale-solving pass, the
        rounds again), outlier removal, full BA, then realign / rematch /
        realign of the tracked non-keyframe frames against the final
        map."""
        with tracer.span("finalize"):
            smap = self.map
            # stop the back-end workers (async mode) before the map is touched
            # from this thread
            if self._async_lba is not None:
                self._async_lba.join()
            self._simp_queue.join()
            self._deferred_queue.join()
            # end-of-run bad-section mitigation: the trailing ~30 frames never
            # received the usual back-end polish, so their keyframes' culling
            # bias goes past the force threshold and simplification sees them
            # before the final BA passes
            valid = smap.valid_keyframes()
            if len(valid):
                last_fid = int(smap.kf_frame_id[valid].max())
                # only when a non-trailing backbone remains: in a short run
                # every keyframe is trailing, and force-culling them all would
                # gut the map
                n_backbone = int((smap.kf_frame_id[valid]
                                  <= last_fid - 30).sum())
                kf = valid[np.argmax(smap.kf_frame_id[valid])]
                while (n_backbone >= 3 and kf >= 0
                       and smap.kf_frame_id[kf] > last_fid - 30):
                    smap.kf_cull_factor[kf] = 5.0
                    self._simp_queue.add(int(kf))
                    kf = int(smap.kf_prev[kf])

            # drain the delayed back-end queues (ForceCleanQueue)
            self._simp_queue.force_clean()
            self._deferred_queue.force_clean()
            if smap.n_keyframes >= 2:
                gba = GlobalBA(self.s, smap, self.device,
                               imu_solver=self.imu_solver)
                gba.full_ba(iterations=gba_iterations)
                sol = self.imu_solver
                if sol is not None and sol.gravity_initialized:
                    # final decoupled-VI alternation
                    # (ImuStateSolver.cpp:469-484)
                    old_gba, sol.gba = sol.gba, gba
                    sol.iterate_ba_imu(vi_alternations)
                    sol.gba = old_gba
                else:
                    gba.full_ba(iterations=gba_iterations)
                gba.remove_outliers()
                gba.full_ba(iterations=gba_iterations)
                # RealignIntermiediateFrames x2 around RematchIntermiediate
                traj_frames = self.tracker.trajectory
                with tracer.span("gba.realign"):
                    gba.realign_intermediate_frames(traj_frames)
                    gba.rematch_intermediate(traj_frames)
                    gba.realign_intermediate_frames(traj_frames)

    def map_statistics(self) -> str:
        """End-of-run map statistics table: ATE RMSE Sim3/SE3, scale error,
        reprojection RMSE, observation density."""
        smap = self.map
        rmse_sim3, scale, n = self.ate_against_gt(with_scale=True)
        rmse_se3, _, _ = self.ate_against_gt(with_scale=False)
        n_obs = int(smap.pt_n_obs[smap.valid_points()].sum())
        n_kf = max(smap.n_keyframes, 1)
        n_pt = max(smap.n_points, 1)
        reproj = smap.reprojection_stats(self.s.fx, self.s.fy,
                                         self.s.cx, self.s.cy)
        lines = [
            f"{'Keyframes':<24}{smap.n_keyframes:>12}",
            f"{'Map points':<24}{smap.n_points:>12}",
            f"{'Observations':<24}{n_obs:>12}",
            f"{'Obs / keyframe':<24}{n_obs / n_kf:>12.1f}",
            f"{'Obs / point':<24}{n_obs / n_pt:>12.2f}",
            f"{'Reprojection RMSE (px)':<24}{reproj:>12.3f}",
        ]
        if n:
            lines.append(f"{'ATE RMSE Sim3 (m)':<24}{rmse_sim3:>12.4f}")
            lines.append(f"{'ATE RMSE SE3 (m)':<24}{rmse_se3:>12.4f}")
            lines.append(
                f"{'Scale error (%)':<24}{abs(1 - scale) * 100:>12.2f}")
        return "\n".join(lines)

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
