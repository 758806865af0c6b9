"""Local bundle adjustment: window selection, packing, solve, write-back.

Counterpart of ``snakeslam_tpu/optim/lba.py`` (the reference's
LocalBundleAdjustment): window = up to 15 covisible + 15 temporally
previous keyframes plus fixed boundary keyframes observing shared points,
solve (3 LM iterations), chi2 outlier classification and erase, and a
guarded commit.  The solve is ``ops/ba.solve_ba`` with fixed (C, P, M)
slots; P is bucketed so the shapes take at most three values per run.
With an IMU state solver, the gyro relative-rotation factors between
consecutive window keyframes fill the problem's relative-pose slots.

On the card the solve and the outlier classification are one compiled
program (``solve_window``, ``utils/graphs.py``): one captured CUDA graph
replayed per local BA, keyed by the buckets (C, P, M, R) and the
iteration count, captured on the thread that calls it (async mode's
worker captures its own).  It returns copies of the graph's outputs: the
pipelined commit reads them a keyframe cycle later.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.map.slam_map import SlamMap
from snakeslam_tpu_torch.ops import ba as BA
from snakeslam_tpu_torch.optim.packing import (
    erase_outlier_observations,
    pack_observations,
)
from snakeslam_tpu_torch.system.settings import Settings
from snakeslam_tpu_torch.tracking.staging import HostCopy
from snakeslam_tpu_torch.utils import graphs

F32 = np.float32


def pack_rpc(imu_solver, kfs, slot_of_kf, n_slots: int, dtype):
    """The relative-pose-constraint arrays (rpc_i, rpc_j, rpc_T, rpc_weight,
    rpc_valid) of a BA problem: the IMU solver's gyro relative-rotation
    factors between consecutive keyframes of ``kfs``, in ``n_slots`` slots;
    without a solver (or before its gyro stage) every slot is invalid."""
    rpc_i = np.zeros(n_slots, dtype=np.int32)
    rpc_j = np.zeros(n_slots, dtype=np.int32)
    rpc_T = np.tile(np.eye(4, dtype=dtype), (n_slots, 1, 1))
    rpc_w = np.zeros((n_slots, 6), dtype=dtype)
    rpc_valid = np.zeros(n_slots, dtype=bool)
    rpc = imu_solver.rpc_for_window(kfs) if imu_solver is not None else None
    for r, (ki, kj, T, w_t, w_r) in enumerate((rpc or [])[:n_slots]):
        rpc_i[r] = slot_of_kf[ki]
        rpc_j[r] = slot_of_kf[kj]
        rpc_T[r] = T
        rpc_w[r, :3] = w_t
        rpc_w[r, 3:] = w_r
        rpc_valid[r] = True
    return rpc_i, rpc_j, rpc_T, rpc_w, rpc_valid


def _solve_window(problem: BA.BAProblem, cam: Pinhole, bf: torch.Tensor,
                  iterations: int = 3):
    """LM solve + chi2 outlier classification of one local-BA problem:
    (cam_pose, points, outlier mask)."""
    cam_pose, points, _ = BA.solve_ba(problem, cam, bf, iterations=iterations)
    outliers = BA.classify_outliers(problem, cam, bf, cam_pose, points)
    return cam_pose, points, outliers


solve_window = graphs.compiled(_solve_window, static=("iterations",),
                               clone=True, name="lba_solve")


class LocalBA:
    def __init__(self, settings: Settings, smap: SlamMap, device,
                 imu_solver=None):
        self.imu_solver = imu_solver
        self.s = settings
        self.map = smap
        self.device = torch.device(device)
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=self.device)
        self.bf = torch.tensor(settings.bf, dtype=torch.float32,
                               device=self.device)
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)
        self.n_runs = 0

    def select_window(self, kf: int):
        """Window KFs (optimized) + boundary KFs (fixed)."""
        smap = self.map
        ids, w = smap.covisible_keyframes(kf, min_weight=1)
        window = [kf] + [int(k) for k in ids[:15]]
        # previous keyframes along the temporal chain
        cur = kf
        for _ in range(15):
            prev = smap.kf_prev[cur]
            if prev < 0 or not smap.kf_valid[prev]:
                break
            if prev not in window:
                window.append(int(prev))
            cur = prev
        window = window[: self.s.lba_cam_slots - 8]  # leave room for boundary

        # points observed by the window
        pts = np.unique(np.concatenate(
            [smap.keyframe_points(k) for k in window]
        )) if window else np.array([], dtype=np.int64)
        pts = pts[smap.pt_valid[pts]]
        if len(pts) > self.s.lba_point_slots:
            pts = pts[: self.s.lba_point_slots]

        # boundary: other KFs observing those points -> fixed
        obs_kfs = smap.pt_obs_kf[pts].ravel()
        obs_kfs = np.unique(obs_kfs[obs_kfs >= 0])
        in_window = np.zeros(smap.max_keyframes, dtype=bool)
        in_window[window] = True
        boundary = [int(k) for k in obs_kfs if not in_window[k]]
        boundary = boundary[: self.s.lba_cam_slots - len(window)]
        return window, boundary, pts

    def pack(self, window, boundary, pts):
        smap = self.map
        C = self.s.lba_cam_slots
        # point slots bucketed in powers of two from max(1024, slots / 4)
        # up to the configured cap: at most three shapes per run
        p_bucket = max(1024, self.s.lba_point_slots // 4)
        while p_bucket < len(pts):
            p_bucket *= 2
        P = min(p_bucket, self.s.lba_point_slots)
        M = self.s.lba_obs_slots
        cams = window + boundary

        cam_pose = np.tile(np.eye(4, dtype=F32), (C, 1, 1))
        cam_fixed = np.ones(C, dtype=bool)
        cam_valid = np.zeros(C, dtype=bool)
        cam_pose[: len(cams)] = smap.kf_pose[cams]
        cam_valid[: len(cams)] = True
        cam_fixed[: len(window)] = False
        # gauge: boundary KFs are the fixed anchors; with no boundary, hold
        # the oldest window KF fixed
        if len(boundary) == 0 and len(window) > 1:
            cam_fixed[len(window) - 1] = True

        slot_of_kf = np.full(smap.max_keyframes, -1, dtype=np.int32)
        slot_of_kf[cams] = np.arange(len(cams), dtype=np.int32)

        points = np.zeros((P, 3), dtype=F32)
        point_valid = np.zeros(P, dtype=bool)
        npts = len(pts)
        points[:npts] = smap.pt_pos[pts]
        point_valid[:npts] = True

        obs = pack_observations(smap, pts, slot_of_kf, P, M,
                                self.pyramid.inv_scales)

        # IMU relative-rotation constraints between consecutive window KFs
        # (LocalBundleAdjustment.cpp:295-347); C slots, invalid without IMU
        rpc = pack_rpc(self.imu_solver, window, slot_of_kf, C, F32)
        problem = BA.problem_to_device(
            cam_pose, cam_fixed, cam_valid, points, point_valid,
            obs["obs_cam"], obs["obs_uv"], obs["obs_right"],
            obs["obs_weight"], obs["obs_valid"], *rpc, self.device,
        )
        # identity stamps for the guarded commit: the pipelined flush
        # commits one cycle late and both pools recycle slots
        aux = dict(cams=cams, pts=pts, n_window=len(window),
                   cam_fids=smap.kf_frame_id[cams].copy(),
                   pts_gen=smap.pt_alloc_gen[pts].copy(), **obs)
        return problem, aux

    # ------------------------------------------------------------------

    def add(self, kf: int):
        """Queue interface (delay 0: synchronous)."""
        self.run(kf)

    def run(self, kf: int, iterations: int = 3):
        """Snapshot -> solve -> guarded commit in one call: the commit is
        dropped whole when the map changed since the snapshot (the
        optimistic-concurrency check of LocalBundleAdjustment.cpp:463-499;
        with one caller at a time it never fires)."""
        disp = self.dispatch(kf, iterations)
        if disp is None:
            return
        self.commit(kf, HostCopy(disp[0]).wait(), disp[1], check_state=True)

    def dispatch(self, kf: int, iterations: int = 3):
        """Async half: snapshot + pack + queue the solve, no blocking.
        Returns ([device tensors], ctx) or None."""
        smap = self.map
        with smap.lock:
            if not smap.kf_valid[kf]:
                return None
            window, boundary, pts = self.select_window(kf)
            if len(window) < 2 or len(pts) < 20:
                return None
            state_before = smap.state
            problem, aux = self.pack(window, boundary, pts)
            aux["state_before"] = state_before

        return list(solve_window(problem, self.cam, self.bf,
                                 iterations=iterations)), aux

    def commit(self, kf: int, fetched, aux, check_state: bool = False):
        """Guarded write-back.  In the keyframe cycle (check_state=False)
        it lands one cycle after the dispatch: the only mutations since
        pack were the cycles' own triangulation / fusion commits, so
        per-element guards (identity stamps, finiteness) decide what is
        written.  ``run`` passes check_state=True: any map change since the
        snapshot drops the commit whole."""
        smap = self.map
        cam_pose, points, outliers = fetched
        with smap.lock:
            if check_state and smap.state != aux["state_before"]:
                return
            cam_pose = cam_pose.astype(np.float64)
            points = points.astype(np.float64)
            win = aux["cams"][: aux["n_window"]]
            # a degenerate window can diverge to NaN (solve_psd of a
            # matrix that is not positive-definite): never commit a
            # non-finite pose or point
            cam_ok = np.isfinite(cam_pose[: len(win)]).all(axis=(1, 2))
            win_arr = np.asarray(win)
            # identity guard: skip slots culled or recycled since pack
            cam_ok &= (smap.kf_valid[win_arr]
                       & (smap.kf_frame_id[win_arr]
                          == aux["cam_fids"][: len(win)]))
            win_arr = win_arr[cam_ok]
            smap.kf_pose[win_arr] = cam_pose[: len(win)][cam_ok]
            pts_arr = np.asarray(aux["pts"])
            live = smap.pt_valid[pts_arr]
            live &= smap.pt_alloc_gen[pts_arr] == aux["pts_gen"]
            pt_new = points[: len(pts_arr)]
            live &= np.isfinite(pt_new).all(axis=1)
            smap.pt_pos[pts_arr[live]] = pt_new[live]

            erase_outlier_observations(
                smap, aux["pts"], outliers, aux["obs_kf_id"],
                aux["obs_feat"], aux["obs_valid"],
            )
            smap.state += 1
            self.n_runs += 1
