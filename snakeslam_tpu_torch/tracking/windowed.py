"""Windowed tracking runner: a speculative device pipeline.

Counterpart of ``snakeslam_tpu/tracking/windowed.py`` in its inline
(deterministic) mode.  Steady-state tracking runs W frames per
``window_track`` call with up to ``depth`` windows in flight.  Windows
chain their carry (pose / velocity / keyframe-decision state) on the
device, so dispatching window k+1 never waits for window k.  Each window's
packed frames go up from a pinned host buffer with a non-blocking copy;
its results come back by non-blocking copies into pinned host tensors
followed by a recorded CUDA event: ``ready()`` queries the event and
``fetch()`` synchronizes on it before numpy reads the host tensors.  The
keyframe decision runs in the loop against a carried virtual-keyframe
state, so speculation stays valid across keyframes: the host inserts the
real keyframe when it consumes the window that holds it, then swaps a
refreshed local-map snapshot into later dispatches.

Initialization, failures and recovery go through the per-frame Tracker
path.  Deterministic: dispatch/consume order is a pure function of the
input sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.models.window_step import (
    frame_buffer_width,
    make_dec_state,
    pack_frames_np,
    window_track,
)
from snakeslam_tpu_torch.system.settings import InputType
from snakeslam_tpu_torch.tracking.tracker import TrackingState


@dataclass
class _InFlight:
    start: int                    # absolute index of the window's 1st frame
    batch: list                   # the (unpadded) FrameData list
    results: tuple                # (outs, assign, vis, fnd) device tensors
    lm_ids: np.ndarray
    lm_gen: np.ndarray            # pt_alloc_gen of lm_ids at snapshot time
    staging: object = None        # pinned upload buffer, alive until done
    host: tuple | None = field(default=None)
    event: object = None

    def start_copy(self):
        """Queue the device->host copies behind the window's compute."""
        if self.host is not None:
            return
        if self.results[0].device.type == "cuda":
            self.host = tuple(
                torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                for a in self.results)
            for h, a in zip(self.host, self.results):
                h.copy_(a, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = self.results

    def ready(self) -> bool:
        """All result tensors have landed host-side."""
        return self.host is not None and (self.event is None
                                          or self.event.query())

    def fetch(self):
        self.start_copy()
        if self.event is not None:
            self.event.synchronize()
        self.staging = None
        return tuple(h.numpy() for h in self.host)


DEPTH = 4   # windows in flight


class WindowedRunner:
    def __init__(self, system, window: int = 64):
        self.system = system
        self.tracker = system.tracker
        self.device = system.device
        self.window = window
        self.n_device_calls = 0
        self._backend_token = None
        self._med_override = -1.0

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
                lm.commit_deferred(prev)

    def _commit_backend(self):
        tok, self._backend_token = self._backend_token, None
        if tok is not None:
            self.tracker.local_mapper.commit_deferred(tok)

    # ------------------------------------------------------------------

    def _initial_dec_state(self) -> np.ndarray:
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
        return make_dec_state(last_kf_matches, smap.kf_timestamp[kf],
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
                self._commit_backend()
                t.local_mapper.flush_deferred()
                self.system.process_frame(frames[i])
                i += 1
                continue
            self._commit_backend()
            lm, lm_ids, lm_gen = self._local_map()
            if lm is None:
                t.local_mapper.flush_deferred()
                self.system.process_frame(frames[i])
                i += 1
                continue
            i = self._run_chain(frames, i, lm, lm_ids, lm_gen)
        self._commit_backend()
        t.local_mapper.flush_deferred()
        return n

    # ------------------------------------------------------------------

    def _dispatch(self, frames, start, W, lm, lm_ids, lm_gen, carry, scal):
        t = self.tracker
        Ns = self.system.s.feature_slots
        batch = frames[start:start + W]
        actual = len(batch)
        padded = batch
        while len(padded) < W:  # pad to the window width (whole rows)
            padded = padded + [padded[-1]]
        cuda = self.device.type == "cuda"
        staging = torch.empty((W, frame_buffer_width(Ns)),
                              dtype=torch.float32, pin_memory=cuda)
        pack_frames_np(padded, Ns, out=staging.numpy())
        # the pinned source stays referenced by the in-flight item until
        # its results are fetched, i.e. after the upload has completed
        buf = staging.to(self.device, non_blocking=True)
        self.n_device_calls += 1
        med = self._med_override
        self._med_override = -1.0
        outs, assign, vis, fnd, carry_out = window_track(
            lm, buf, carry[0], carry[1], carry[2], carry[3],
            t.cam, t.bf, t.bounds, t.scales, t.log_sf,
            t.coarse_radius, t.fine_th,
            n_valid_frames=actual, med_override=med,
            n_slots=Ns, **scal,
        )
        item = _InFlight(start=start, batch=batch,
                         results=(outs, assign, vis, fnd),
                         lm_ids=lm_ids, lm_gen=lm_gen, staging=staging)
        return item, carry_out

    def _run_chain(self, frames, i, lm, lm_ids, lm_gen) -> int:
        """Dispatch chained windows speculatively from frame i; returns the
        index of the first frame NOT consumed.  A keyframe does not break
        the chain; it ends on tracking failure, a snapshot bucket-size
        change, or end of input."""
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
        carry = (
            torch.as_tensor(t.last_frame.pose_cw, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(t.velocity, dtype=torch.float32, device=dev),
            torch.from_numpy(self._initial_dec_state()).to(dev),
            torch.zeros((), dtype=torch.bool, device=dev),
        )
        self._med_override = -1.0  # a fresh dec_state already carries med
        bucket = int(lm.position.shape[0])

        inflight: list[_InFlight] = []
        next_i = i
        stop_dispatch = False
        failed_at = -1

        def top_up():
            nonlocal next_i, carry
            while (not stop_dispatch and next_i < n
                   and len(inflight) < DEPTH):
                item, carry = self._dispatch(
                    frames, next_i, W, lm, lm_ids, lm_gen, carry, scal)
                next_i += len(item.batch)
                inflight.append(item)
                # queue the D2H copy at dispatch time, behind the window
                item.start_copy()

        top_up()
        consumed_to = i
        refresh_in = 0   # countdown of blocking fetch points until commit
        refresh_pending = False
        while inflight:
            item = inflight.pop(0)
            for nxt in inflight:
                nxt.start_copy()
            group = [(item, item.fetch())]
            # later windows whose copies have landed are consumed now
            while inflight and inflight[0].ready():
                nxt = inflight.pop(0)
                group.append((nxt, nxt.fetch()))

            def do_refresh():
                """Commit the pending cycle + swap the refreshed snapshot."""
                nonlocal refresh_pending, stop_dispatch, lm, lm_ids, lm_gen
                refresh_pending = False
                self._commit_backend()
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

            if refresh_in > 0:
                refresh_in -= 1
            if refresh_pending and refresh_in == 0:
                # deterministic commit point: two blocking window fetches
                # after the cycle's dispatch
                do_refresh()
            got_kf = None
            for it, (outs, assign, vis, fnd) in group:
                r = self._consume(it, outs, assign, vis, fnd)
                if r is not None and r is not True and r < 0:
                    got_kf = r
                    break
                consumed_to = it.start + len(it.batch)
                if r:
                    got_kf = True
            if got_kf is not None and got_kf is not True and got_kf < 0:
                failed_at = -(got_kf + 1)
                inflight.clear()
                break
            if got_kf:
                self._dispatch_backend_cycles()
                refresh_in = 2
                refresh_pending = True
            top_up()

        if failed_at >= 0:
            self._commit_backend()
            t.local_mapper.flush_deferred()
            self.system.process_frame(frames[failed_at])
            return failed_at + 1
        self._commit_backend()
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
                self._commit_stats(item, vis, fnd)
                _update_velocity(w)
                return -(item.start + w + 1)
            frame.pose_cw = poses[w]
            frame.matches = matches_all[w, : frame.n].copy()
            frame.outlier = np.zeros(frame.n, dtype=bool)
            frame.ref_kf = t.last_kf
            frame.capture_rel(t.map.kf_pose[t.last_kf],
                              t.map.kf_frame_id[t.last_kf])
            t.last_tracked_frame = frame
            t.last_frame = frame
            t.trajectory.append(frame)
            self.system.n_frames += 1
            if row[18] > 0.5:   # need_kf
                kf = t.local_mapper.insert_keyframe(frame, t.last_kf,
                                                    defer=True)
                if kf >= 0:
                    t.last_kf = kf
                    inserted = True
        _update_velocity(len(item.batch))
        self._commit_stats(item, vis, fnd)
        return True if inserted else None

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
