"""Windowed tracking runner: a speculative device pipeline.

Counterpart of ``snakeslam_tpu/tracking/windowed.py``.  Steady-state
tracking runs W frames per ``window_track`` call with up to ``depth``
windows in flight.  Windows chain their carry (pose / velocity /
keyframe-decision state) on the device, so dispatching window k+1 never
waits for window k.  On the card each call is one replay of the window's
captured CUDA graph (``utils/graphs.py``): its packed frames go up from a
pinned host buffer straight into the graph's static frame input with a
non-blocking copy, the previous window's carry outputs are copied into
the static carry inputs on the device, and a refreshed snapshot into the
static local-map inputs.  Its results come back by non-blocking copies
into pinned host tensors, queued at dispatch right behind the replay
(``staging.HostCopy``): nothing reads a window's device outputs after the
next replay overwrites them.  Frame times are packed relative to the
chain's time origin (``window_step.time_origin``).
The keyframe decision runs in the loop against a carried virtual-keyframe
state, so speculation stays valid across keyframes: the host inserts the
real keyframe when it consumes the window that holds it, dispatches the
keyframe cycle (triangulation, fusion, local BA) and, two window fetches
later, commits it and swaps a refreshed local-map snapshot into later
dispatches.  With an IMU state solver the keyframe cycle commits
synchronously and the snapshot is refreshed at once, because a
visual-inertial initialization stage in that commit can rescale the whole
map; windows then carry the gyro-predicted rotation of every frame.  A
whole-map transform (``SlamMap.transform``) since the chain began ends the
chain at the next refresh point and drops the windows in flight: they were
computed in the old basis.

Async mode (``async_backends``, by default the settings' ``async_mode``:
the reference's async deployment setting) moves keyframe insertion and
the back-ends onto one worker thread, so all map mutation stays serialized
there while the main thread dispatches and consumes windows; the snapshot
refresh waits until the worker is idle.  Async mode makes no determinism
claim.

Initialization, failures and recovery go through the per-frame Tracker
path.  Inline mode is deterministic: windows are consumed one per
blocking fetch, so the dispatch / consume / commit order is a pure
function of the input sequence. (The JAX package also consumes, in the
same fetch, later windows whose copies have already landed: on its
remote TPU that saved round trips, but the grouping then depends on
timing. A synchronous CPU run or a host-bound GPU run would find every
window landed and insert all their keyframes before the first keyframe
cycle; one window per fetch is the schedule the JAX package runs when
the device is the slower side.)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.models.window_step import (
    frame_buffer_width,
    make_dec_state,
    pack_frames_np,
    time_origin,
    window_track,
)
from snakeslam_tpu_torch.ops.imu import so3_exp_np
from snakeslam_tpu_torch.system.settings import InputType
from snakeslam_tpu_torch.tracking.staging import HostCopy, upload
from snakeslam_tpu_torch.tracking.tracker import TrackingState


@dataclass
class _InFlight:
    start: int                    # absolute index of the window's 1st frame
    batch: list                   # the (unpadded) FrameData list
    results: tuple                # (outs, assign, vis, fnd) device tensors
    lm_ids: np.ndarray
    lm_gen: np.ndarray            # pt_alloc_gen of lm_ids at snapshot time
    staging: object = None        # pinned upload buffers, alive until done

    def __post_init__(self):
        # the device->host copies queue behind the window's compute
        self.copy = HostCopy(self.results)

    def fetch(self):
        out = self.copy.wait()
        self.staging = None
        return out


DEPTH = 4   # windows in flight


def gyro_delta_rotation(omega: np.ndarray, dt: np.ndarray,
                        bg: np.ndarray) -> np.ndarray:
    """Body-frame relative rotation dR = prod exp((w - bg) dt) over the
    frame's gyro samples (host-side; a handful of 3x3 products)."""
    dR = np.eye(3)
    for inc in so3_exp_np((omega - bg) * dt[:, None]):
        dR = dR @ inc
    return dR


class WindowedRunner:
    def __init__(self, system, window: int = 64, two_stage: bool = True,
                 depth: int = DEPTH, async_backends: bool | None = None):
        self.system = system
        self.tracker = system.tracker
        self.device = system.device
        self.window = window
        self.two_stage = two_stage
        self.depth = max(1, depth)
        self.imu_solver = getattr(system, "imu_solver", None)
        if self.imu_solver is not None:
            # visual-inertial runs cap the speculation depth: every extra
            # window in flight extends how long tracking runs on a stale
            # pre-keyframe snapshot, and monocular scale drift compounds
            # with that staleness until the VI initialization inherits a
            # distorted map (the JAX package's note: depth 4 gave Sim3 ATE
            # 0.167 m against 0.008 m at depth 3 on the synthetic orbit).
            # Stereo / RGB-D have absolute scale and keep the deeper
            # pipeline.
            self.depth = min(self.depth, 3)
        self.n_device_calls = 0
        self.n_chain_restarts = 0   # chains ended by a whole-map transform
        self._backend_token = None
        self._med_override = -1.0
        if async_backends is None:
            async_backends = bool(system.s.async_mode)
        self.async_backends = async_backends
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="snake-backend")
                      if async_backends else None)
        self._pending = []

    # -- the serialized map-mutation worker (async mode) -------------------

    def _submit(self, fn, *args):
        """Run ``fn`` inline, or queue it on the worker in async mode."""
        if self._pool is None:
            return fn(*args)
        self._pending.append(self._pool.submit(fn, *args))
        return None

    def _drain(self):
        """Wait until all queued map work has completed (raising any
        worker exception here), then commit the pending inline cycle."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        self._commit_backend()

    def _backend_ready(self) -> bool:
        """Gate of the snapshot refresh: inline mode is always ready (the
        commit blocks at a fixed point of the consume schedule); async mode
        waits until the worker is idle."""
        if not self._pending:
            return True
        if all(f.done() for f in self._pending):
            for f in self._pending:
                f.result()
            self._pending = []
            return True
        return False

    # -- inline back-end pipeline ------------------------------------------

    def _dispatch_backend_cycles(self):
        t = self.tracker
        lm = t.local_mapper
        while lm._deferred:
            kf, frame = lm._deferred.pop(0)
            if not t.map.kf_valid[kf]:
                continue
            prev, self._backend_token = self._backend_token, None
            self._backend_token = lm.dispatch_deferred(kf)
            if prev is not None:
                lm.commit_deferred_checked(prev)
            if self.imu_solver is not None:
                # visual-inertial: the commit can move the whole map (VI
                # init stages apply gravity / scale transforms), so it must
                # land before any later window is consumed: the cycle stays
                # synchronous
                self._commit_backend()

    def _commit_backend(self):
        tok, self._backend_token = self._backend_token, None
        if tok is not None:
            self.tracker.local_mapper.commit_deferred_checked(tok)

    def _use_imu(self) -> bool:
        sol = self.imu_solver
        return sol is not None and sol.gyro_initialized

    def _attach_imu_prediction(self, batch):
        """Gyro-predicted camera-frame relative rotation per frame (the
        window's prediction input; TrackingCoarse.cpp:322-327)."""
        sol = self.imu_solver
        R_cb = sol.R_cb
        for f in batch:
            if getattr(f, "imu_dR_cam", None) is not None:
                continue
            if f.imu_omega is None or not len(f.imu_omega):
                f.imu_dR_cam = np.eye(3)
                continue
            dR = gyro_delta_rotation(f.imu_omega, f.imu_dt, sol.bg)
            f.imu_dR_cam = R_cb @ dR.T @ R_cb.T

    # ------------------------------------------------------------------

    def _initial_dec_state(self, t0: float = 0.0) -> np.ndarray:
        """The keyframe-decision carry of a chain whose time origin is
        ``t0``."""
        t = self.tracker
        smap = t.map
        kf = t.last_kf
        kf_pts = smap.keyframe_points(kf)
        min_obs = 2 if smap.n_keyframes <= 2 else 3
        last_kf_matches = max(int((smap.pt_n_obs[kf_pts] >= min_obs).sum()), 1)
        T = smap.kf_pose[kf]
        center = -T[:3, :3].T @ T[:3, 3]
        viewdir = T[:3, :3].T @ np.array([0.0, 0.0, 1.0])
        med = smap.kf_median_depth[kf] or smap.compute_median_depth(kf)
        frames_since = (int(t.last_frame.frame_id)
                        - int(smap.kf_frame_id[kf]))
        return make_dec_state(last_kf_matches, smap.kf_timestamp[kf] - t0,
                              center, viewdir, max(med, 1e-3), frames_since)

    def _local_map(self):
        t = self.tracker
        lf = t.last_frame
        matched = (lf.matches[lf.matches >= 0]
                   if lf is not None and lf.matches is not None
                   else np.array([], dtype=np.int64))
        if t.map.state == t._fine_cache_state and t._fine_cache[0] is not None:
            return t._fine_cache
        # power-of-two snapshot buckets (or pinned to local_map_slots)
        uniq = np.unique(matched)
        n_live = int(t.map.pt_valid.sum())
        s = self.system.s
        if getattr(s, "pin_local_map_bucket", False):
            bucket = s.local_map_slots
        else:
            bucket = max(1024, s.local_map_slots // 8)
            while bucket < min(n_live + 256, s.local_map_slots):
                bucket *= 2
            bucket = min(bucket, s.local_map_slots)
        lm, ids = t._fine_local_map(uniq, n_slots=bucket)
        if lm is None:
            return None, None, None
        # gen stamps: consumes drop matches whose slot was recycled
        gen = t.map.pt_alloc_gen[ids].copy()
        t._fine_cache = (lm, ids, gen)
        t._fine_cache_state = t.map.state
        return lm, ids, gen

    # ------------------------------------------------------------------

    def run(self, frames: list[FrameData]) -> int:
        i = 0
        n = len(frames)
        t = self.tracker
        while i < n:
            if t.state != TrackingState.OK or t.last_frame is None \
                    or t.last_frame.pose_cw is None:
                self._drain()
                t.local_mapper.flush_deferred()
                self.system.process_frame(frames[i])
                i += 1
                continue
            self._drain()
            lm, lm_ids, lm_gen = self._local_map()
            if lm is None:
                t.local_mapper.flush_deferred()
                self.system.process_frame(frames[i])
                i += 1
                continue
            i = self._run_chain(frames, i, lm, lm_ids, lm_gen)
        self._drain()
        t.local_mapper.flush_deferred()
        return n

    # ------------------------------------------------------------------

    def _dispatch(self, frames, start, W, lm, lm_ids, lm_gen, carry, scal,
                  t0: float = 0.0):
        t = self.tracker
        Ns = self.system.s.feature_slots
        batch = frames[start:start + W]
        actual = len(batch)
        use_imu = self._use_imu()
        if use_imu:
            self._attach_imu_prediction(batch)
        padded = batch
        while len(padded) < W:  # pad to the window width (whole rows)
            padded = padded + [padded[-1]]
        cuda = self.device.type == "cuda"
        # the pinned sources stay referenced by the in-flight item until its
        # results are fetched, i.e. after the uploads have completed; on the
        # card the window program copies them straight into its inputs
        staging = torch.empty((W, frame_buffer_width(Ns)),
                              dtype=torch.float32, pin_memory=cuda)
        pack_frames_np(padded, Ns, out=staging.numpy(), t0=t0)
        n_valid = torch.full((), actual, dtype=torch.int32, pin_memory=cuda)
        med = torch.full((), self._med_override, dtype=torch.float32,
                         pin_memory=cuda)
        self._med_override = -1.0
        self.n_device_calls += 1      # one window program call (a replay)
        outs, assign, vis, fnd, carry_out = window_track(
            lm, staging, carry[0], carry[1], carry[2], carry[3],
            t.cam, t.bf, t.bounds, t.scales, t.log_sf,
            t.coarse_radius, t.fine_th,
            n_valid_frames=n_valid, med_override=med,
            n_slots=Ns, two_stage=self.two_stage, use_imu=use_imu, **scal,
        )
        item = _InFlight(start=start, batch=batch,
                         results=(outs, assign, vis, fnd),
                         lm_ids=lm_ids, lm_gen=lm_gen,
                         staging=(staging, n_valid, med))
        return item, carry_out

    def _run_chain(self, frames, i, lm, lm_ids, lm_gen) -> int:
        """Dispatch chained windows speculatively from frame i; returns the
        index of the first frame NOT consumed.  A keyframe does not break
        the chain; it ends on tracking failure, a whole-map transform, a
        snapshot bucket-size change, or end of input."""
        t = self.tracker
        dev = self.device
        n = len(frames)
        W = self.window
        scal = dict(
            kfi_target=torch.tensor(float(t.s.kfi_target_matches),
                                    dtype=torch.float32, device=dev),
            is_stereo=torch.tensor(t.s.input_type == InputType.Stereo,
                                   dtype=torch.bool, device=dev),
            th_depth=torch.tensor(float(t.s.th_depth), dtype=torch.float32,
                                  device=dev),
        )
        # frame times of this chain are packed relative to t0
        t0 = time_origin(frames[i].timestamp)
        carry = (
            upload(np.asarray(t.last_frame.pose_cw, np.float32), dev),
            upload(np.asarray(t.velocity, np.float32), dev),
            upload(self._initial_dec_state(t0), dev),
            torch.zeros((), dtype=torch.bool, device=dev),
        )
        self._med_override = -1.0  # a fresh dec_state already carries med
        bucket = int(lm.position.shape[0])

        inflight: list[_InFlight] = []
        next_i = i
        stop_dispatch = False
        failed_at = -1
        transforms_before = getattr(t.map, "n_transforms", 0)

        def top_up():
            nonlocal next_i, carry
            while (not stop_dispatch and next_i < n
                   and len(inflight) < self.depth):
                item, carry = self._dispatch(
                    frames, next_i, W, lm, lm_ids, lm_gen, carry, scal, t0)
                next_i += len(item.batch)
                inflight.append(item)

        top_up()
        consumed_to = i
        refresh_in = 0   # countdown of blocking fetch points until commit
        refresh_pending = False
        while inflight:
            item = inflight.pop(0)
            outs, assign, vis, fnd = item.fetch()

            def rebased():
                """True when a whole-map transform (loop correction,
                VI-init stage) landed since the chain began: poses already
                consumed were rebased by the tracker's transform listener,
                but the windows in flight were computed in the old basis:
                they are dropped and the chain must restart."""
                nonlocal stop_dispatch
                if getattr(t.map, "n_transforms", 0) == transforms_before:
                    return False
                inflight.clear()
                stop_dispatch = True
                self.n_chain_restarts += 1
                return True

            def do_refresh():
                """Commit the pending cycle + swap the refreshed snapshot.
                Returns True when the chain must restart (map rebase)."""
                nonlocal refresh_pending, stop_dispatch, lm, lm_ids, lm_gen
                refresh_pending = False
                self._drain()
                if rebased():
                    return True
                new_lm, new_ids, new_gen = self._local_map()
                if new_lm is None:
                    stop_dispatch = True
                elif int(new_lm.position.shape[0]) != bucket:
                    stop_dispatch = True
                else:
                    lm, lm_ids, lm_gen = new_lm, new_ids, new_gen
                    # refresh the carried median scene depth in the next
                    # dispatch (the in-loop virtual-keyframe reset cannot)
                    med = t.map.kf_median_depth[t.last_kf] \
                        or t.map.compute_median_depth(t.last_kf)
                    self._med_override = max(med, 1e-3)
                return False

            if refresh_in > 0:
                refresh_in -= 1
            if refresh_pending and refresh_in == 0 and self._backend_ready():
                # deterministic commit point: two blocking window fetches
                # after the cycle's dispatch.  On a restart the fetched
                # window is dropped unconsumed with the rest in flight
                if do_refresh():
                    break
            r = self._consume(item, outs, assign, vis, fnd)
            if r is not None and r is not True and r < 0:
                failed_at = -(r + 1)
                inflight.clear()
                break
            consumed_to = item.start + len(item.batch)
            if r and self._pool is not None:
                # the worker runs the cycles; the refresh waits for it
                self._submit(t.local_mapper.flush_deferred)
                refresh_in = 2
                refresh_pending = True
            elif r:
                self._dispatch_backend_cycles()
                if rebased():
                    # the pipelined commit of the previous cycle carried
                    # the transform (the JAX runner notices only at the
                    # refresh point, two windows later)
                    break
                refresh_in = 2
                refresh_pending = True
                if self.imu_solver is not None:
                    # VI commits are synchronous (they can rescale the
                    # whole map, see _dispatch_backend_cycles): refresh the
                    # snapshot and run the rebase check at once, so no
                    # window is dispatched or consumed against a rescaled
                    # map in the old basis
                    if do_refresh():
                        break
            top_up()

        if failed_at >= 0:
            self._drain()
            t.local_mapper.flush_deferred()
            self.system.process_frame(frames[failed_at])
            return failed_at + 1
        self._drain()
        t.local_mapper.flush_deferred()
        return consumed_to

    def _consume(self, item: _InFlight, outs, assign, vis, fnd):
        """Apply one window's results to host state.

        Returns None (clean, no KF), True (>=1 KF inserted), or a negative
        number -(abs_index+1) when tracking failed at abs_index."""
        t = self.tracker
        lm_ids = item.lm_ids
        inserted = False
        a_all = assign.astype(np.int64)
        safe = np.clip(a_all, 0, max(len(lm_ids) - 1, 0))
        # drop matches whose point slot was recycled while in flight
        fresh = t.map.pt_alloc_gen[lm_ids[safe]] == item.lm_gen[safe]
        matches_all = np.where((a_all >= 0) & fresh, lm_ids[safe], -1)
        poses = outs[:, :16].reshape(-1, 4, 4).astype(np.float64)
        prev_pose = (t.last_tracked_frame.pose_cw
                     if t.last_tracked_frame is not None else None)

        def _update_velocity(n_done):
            if n_done >= 2:
                t.velocity = poses[n_done - 1] @ np.linalg.inv(
                    poses[n_done - 2])
            elif n_done == 1 and prev_pose is not None:
                t.velocity = poses[0] @ np.linalg.inv(prev_pose)

        for w, frame in enumerate(item.batch):
            row = outs[w]
            if row[19] > 0.5:   # stopped before this frame
                _update_velocity(w)
                return -(item.start + w + 1)
            if row[17] < 0.5:   # not ok
                self._submit(self._commit_stats, item, vis, fnd)
                _update_velocity(w)
                return -(item.start + w + 1)
            if self.imu_solver is not None:
                # keep the keyframe edges' preintegration windows complete
                # (serialized with the worker's update_map)
                self._submit(self.imu_solver.add_frame_samples, frame)
            frame.pose_cw = poses[w]
            frame.matches = matches_all[w, : frame.n].copy()
            t.map.stamp_matches(frame)
            frame.outlier = np.zeros(frame.n, dtype=bool)
            # last_kf is written by keyframe insertion: read it where that
            # runs, after any insertion queued for an earlier frame
            self._submit(self._set_ref_kf, frame)
            t.last_tracked_frame = frame
            t.last_frame = frame
            t.trajectory.append(frame)
            self.system.n_frames += 1
            if row[18] > 0.5:   # need_kf
                if self._pool is None:
                    inserted |= self._insert_kf(frame)
                else:
                    self._submit(self._insert_kf, frame)
                    inserted = True
        _update_velocity(len(item.batch))
        self._submit(self._commit_stats, item, vis, fnd)
        return True if inserted else None

    def _set_ref_kf(self, frame):
        t = self.tracker
        frame.ref_kf = t.last_kf
        frame.capture_rel(t.map.kf_pose[t.last_kf],
                          t.map.kf_frame_id[t.last_kf])

    def _insert_kf(self, frame) -> bool:
        t = self.tracker
        kf = t.local_mapper.insert_keyframe(frame, t.last_kf, defer=True)
        if kf >= 0:
            t.last_kf = kf
        return kf >= 0

    def _commit_stats(self, item, vis, fnd):
        """Per-point visible/found sums; slots recycled since the window's
        snapshot are skipped."""
        t = self.tracker
        lm_ids = item.lm_ids
        nlm = len(lm_ids)
        fresh = t.map.pt_alloc_gen[lm_ids] == item.lm_gen
        ids = lm_ids[fresh]
        np.add.at(t.map.pt_visible, ids,
                  vis[:nlm][fresh].astype(t.map.pt_visible.dtype))
        np.add.at(t.map.pt_found, ids,
                  fnd[:nlm][fresh].astype(t.map.pt_found.dtype))
