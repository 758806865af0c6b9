"""Global bundle adjustment, outlier removal, and the end-of-run rematch and
realign of the non-keyframe frames.

Counterpart of ``snakeslam_tpu/optim/gba.py`` (the reference's
GlobalBundleAdjustment): FullBA over every keyframe with the first and the
latest held constant, PointBA (points only), outlier-observation removal,
RematchIntermediate (projection re-matching of tracked frames against the
final map, up to 32 frames of one reference keyframe per batched search)
and RealignIntermediateFrames (robust pose-only refinement of every kept
frame: on CUDA tensors one batched launch of the pose kernel of
``ops/pose_fused``, on CPU tensors ``robust_pose_refine`` per frame).

Shapes are bucketed to powers of two: C keyframe slots from 16, P point
slots from 256, 16 observation slots a point.

With ``n_devices > 1`` FullBA runs the sharded Gauss-Newton step of
``parallel/multichip.py`` (points split over a mesh of that many shards,
the reduced camera system reduced on the mesh's first device) and returns
NaN for its cost, as the JAX package does; PointBA and outlier removal
stay unsharded.

The three BA passes run in float64 (the JAX package runs them in float32):
on a long keyframe chain the reduced camera system is ill-conditioned, and
float32 rounding of its assembly and Cholesky solve moved the middle of a
20-keyframe loop by ~5 mm between two summation orders (CPU and GPU) in
one 3-iteration full BA; in float64 the two agree to ~1 um.

On the card the three unsharded passes are compiled programs
(``utils/graphs.py``), as the JAX package jits them: ``full_ba_solve``,
``point_ba_solve`` and ``outlier_classify``, one captured CUDA graph per
(C, P) bucket and static settings (iterations, chi2 thresholds).  The
sharded step (``n_devices > 1``) runs eagerly over its mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.map.slam_map import SlamMap
from snakeslam_tpu_torch.ops import ba as BA
from snakeslam_tpu_torch.ops import matching as M
from snakeslam_tpu_torch.ops.pose_fused import pose_refine_fused
from snakeslam_tpu_torch.ops.pose_solver import PoseObs, robust_pose_refine
from snakeslam_tpu_torch.optim.lba import pack_rpc
from snakeslam_tpu_torch.optim.packing import (
    erase_outlier_observations,
    pack_observations,
)
from snakeslam_tpu_torch.parallel import multichip as MC
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.system.settings import Settings
from snakeslam_tpu_torch.tracking.staging import (HostCopy,
                                                  pad_frames_features, upload)
from snakeslam_tpu_torch.utils import graphs

F32 = np.float32

# the passes' programs; clone: each pass's graphs, one per (C, P) bucket,
# share one memory pool
full_ba_solve = graphs.compiled(
    BA.solve_ba, static=("iterations", "huber_mono", "huber_stereo",
                         "lm_lambda0", "optimize_points"),
    clone=True, name="gba_full_ba")
point_ba_solve = graphs.compiled(
    BA.solve_point_only,
    static=("iterations", "huber_mono", "huber_stereo"), clone=True,
    name="gba_point_ba")
outlier_classify = graphs.compiled(
    BA.classify_outliers, static=("chi2_mono", "chi2_stereo"), clone=True,
    name="gba_outliers")


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class GlobalBA:
    def __init__(self, settings: Settings, smap: SlamMap, device,
                 imu_solver=None):
        self.imu_solver = imu_solver
        self.s = settings
        self.map = smap
        self.device = torch.device(device)
        # float32 for the pose kernel and the matcher, float64 for the BA
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=self.device)
        self.bf = torch.tensor(settings.bf, dtype=torch.float32,
                               device=self.device)
        self.cam64 = Pinhole(*(c.to(torch.float64) for c in self.cam))
        self.bf64 = self.bf.to(torch.float64)
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)
        # with n_devices > 1 every full BA runs the sharded step over a
        # mesh of that many shards on this device's kind (always sharded:
        # the JAX package falls back to the unsharded solve when it finds
        # fewer devices)
        self._mesh = None
        self._sharded_fns: dict = {}
        if settings.n_devices > 1:
            self._mesh = MC.make_mesh(settings.n_devices, self.device)

    def _sharded_full_ba(self, problem, iterations: int):
        fn = self._sharded_fns.get(iterations)
        if fn is None:
            fn = MC.sharded_ba_step(self._mesh, self.cam64, self.bf64,
                                    n_iters=iterations)
            self._sharded_fns[iterations] = fn
        return fn(MC.shard_problem(problem, self._mesh))

    # ------------------------------------------------------------------

    def pack_full(self, obs_slots: int = 16):
        smap = self.map
        kfs = smap.valid_keyframes()
        kfs = kfs[np.argsort(smap.kf_frame_id[kfs])]
        pts = smap.valid_points()
        C = _bucket(len(kfs))
        P = _bucket(len(pts), minimum=256)

        cam_pose = np.tile(np.eye(4), (C, 1, 1))
        cam_fixed = np.ones(C, dtype=bool)
        cam_valid = np.zeros(C, dtype=bool)
        cam_pose[: len(kfs)] = smap.kf_pose[kfs]
        cam_valid[: len(kfs)] = True
        cam_fixed[: len(kfs)] = False
        # gauge: first KF fixed; latest KF constant (GBA:376-378)
        cam_fixed[0] = True
        cam_fixed[len(kfs) - 1] = True

        points = np.zeros((P, 3))
        point_valid = np.zeros(P, dtype=bool)
        points[: len(pts)] = smap.pt_pos[pts]
        point_valid[: len(pts)] = True

        slot_of_kf = np.full(smap.max_keyframes, -1, dtype=np.int32)
        slot_of_kf[kfs] = np.arange(len(kfs), dtype=np.int32)
        obs = pack_observations(smap, pts, slot_of_kf, P, obs_slots,
                                self.pyramid.inv_scales)

        # IMU relative-pose constraints over the whole keyframe chain
        # (GlobalBundleAdjustment.cpp:427-481): C slots with a solver past
        # its gyro stage, else one invalid slot
        kf_list = [int(k) for k in kfs]
        has_rpc = (self.imu_solver is not None
                   and self.imu_solver.rpc_for_window(kf_list))
        rpc = pack_rpc(self.imu_solver if has_rpc else None, kf_list,
                       slot_of_kf, C if has_rpc else 1, np.float64)
        problem = BA.problem_to_device(
            cam_pose, cam_fixed, cam_valid, points, point_valid,
            obs["obs_cam"], obs["obs_uv"], obs["obs_right"],
            obs["obs_weight"], obs["obs_valid"], *rpc, self.device,
            float_dtype=np.float64,
        )
        return problem, dict(kfs=kfs, pts=pts, **obs)

    # ------------------------------------------------------------------

    def full_ba(self, iterations: int = 5):
        with tracer.span("gba.full_ba"):
            smap = self.map
            if smap.n_keyframes < 2 or smap.n_points < 20:
                return
            problem, aux = self.pack_full()
            if self._mesh is not None:
                cam_pose, points = HostCopy(
                    self._sharded_full_ba(problem, iterations)).wait()
                cost = float("nan")
            else:
                cam_pose, points, cost = HostCopy(full_ba_solve(
                    problem, self.cam64, self.bf64,
                    iterations=iterations)).wait()
            smap.kf_pose[aux["kfs"]] = cam_pose[: len(aux["kfs"])]
            smap.pt_pos[aux["pts"]] = points[: len(aux["pts"])]
            smap.state += 1
            return float(cost)

    def point_ba(self, iterations: int = 4):
        smap = self.map
        if smap.n_points < 10:
            return
        problem, aux = self.pack_full()
        points = HostCopy([point_ba_solve(
            problem, self.cam64, self.bf64, iterations=iterations)]).wait()[0]
        smap.pt_pos[aux["pts"]] = points[: len(aux["pts"])]
        smap.state += 1

    def remove_outliers(self, factor: float = 0.75):
        """Erase observations with chi2 above factor * threshold^2 (0.75 *
        th^2 before the final BA, System.cpp:202-205)."""
        smap = self.map
        problem, aux = self.pack_full()
        out = HostCopy([outlier_classify(
            problem, self.cam64, self.bf64, problem.cam_pose, problem.points,
            chi2_mono=factor * 2.1**2, chi2_stereo=factor * 2.3**2,
        )]).wait()[0]
        removed = erase_outlier_observations(
            smap, aux["pts"], out, aux["obs_kf_id"], aux["obs_feat"],
            aux["obs_valid"],
        )
        smap.state += 1
        return removed

    # ------------------------------------------------------------------

    def realign_intermediate_frames(self, frames):
        """Pose-only refinement of all tracked (non-keyframe) frames against
        the final map (RealignIntermiediateFrames,
        GlobalBundleAdjustment.cpp:124-329), 4 x 3 iterations: on a CUDA
        device one batched launch of the pose kernel (B = the frames kept,
        N = feature_slots).  Returns the number of frames refined."""
        smap = self.map
        N = self.s.feature_slots
        kept, starts = [], []
        for f in frames:
            if f.pose_cw is None or f.matches is None or f.is_keyframe:
                continue
            # a match whose point slot was reused since tracking names an
            # unrelated point: dropped (the JAX package keeps it)
            m = smap.live_matches(f)
            if m.sum() < 10:
                continue
            # start from the pose composed through the reference keyframe:
            # after a loop correction the stored absolute pose is in the
            # pre-correction basis and the GN would start a basin away
            T0 = f.pose_cw
            if (f.rel_to_ref is not None and f.ref_kf >= 0
                    and smap.kf_valid[f.ref_kf]
                    and smap.kf_frame_id[f.ref_kf] == f.ref_frame_id):
                T0 = f.rel_to_ref @ smap.kf_pose[f.ref_kf]
            kept.append((f, m))
            starts.append(T0)
        if not kept:
            return 0
        B = len(kept)
        pts = np.zeros((B, N, 3), dtype=F32)
        uv = np.zeros((B, N, 2), dtype=F32)
        right = np.full((B, N), -1.0, dtype=F32)
        w = np.ones((B, N), dtype=F32)
        mask = np.zeros((B, N), dtype=bool)
        inv_scale = self.pyramid.inv_scales
        for b, (f, m) in enumerate(kept):
            n = min(f.n, N)
            sel = np.nonzero(m[:n])[0]
            pts[b, sel] = smap.pt_pos[f.matches[sel]]
            uv[b, :n] = f.uv[:n]
            right[b, :n] = f.right[:n]
            w[b, :n] = inv_scale[np.clip(f.octave[:n], 0, len(inv_scale) - 1)]
            mask[b, sel] = True
        dev = self.device
        Ts = upload(np.stack(starts).astype(F32), dev)
        args = [upload(a, dev) for a in (pts, uv, right, w, mask)]
        if dev.type == "cuda":
            refined, _, n_inl = pose_refine_fused(
                Ts, *args, self.cam, self.bf, outer_iters=4, inner_iters=3)
        else:
            outs = [robust_pose_refine(Ts[b], PoseObs(*(a[b] for a in args)),
                                       self.cam, self.bf)
                    for b in range(B)]
            refined = torch.stack([o[0] for o in outs])
            n_inl = torch.stack([o[2] for o in outs])
        refined, n_inl = HostCopy([refined, n_inl]).wait()
        refined = refined.astype(np.float64)
        for b, (f, _) in enumerate(kept):
            if n_inl[b] >= 10:
                f.pose_cw = refined[b]
                if (f.ref_kf >= 0 and smap.kf_valid[f.ref_kf]
                        and smap.kf_frame_id[f.ref_kf] == f.ref_frame_id):
                    f.capture_rel(smap.kf_pose[f.ref_kf],
                                  smap.kf_frame_id[f.ref_kf])
                else:
                    # reference culled: the realigned absolute pose (solved
                    # against the final map) is the authoritative estimate
                    f.rel_to_ref = None
        return B

    def rematch_intermediate(self, frames, max_group: int = 32):
        """Re-match non-keyframe frames against the final map before the
        pose-only realign (RematchIntermiediate, System.cpp:269-303): the
        frames of one reference keyframe go through the projection matcher
        in batches of up to ``max_group``, one batched search each."""
        smap = self.map
        dev = self.device
        N = self.s.feature_slots
        P = self.s.local_map_slots
        st = M.ScaleTables.from_pyramid(self.pyramid, device=dev)
        bounds = (0.0, 0.0, float(self.s.width), float(self.s.height))

        # group by reference keyframe
        groups: dict[int, list] = {}
        for f in frames:
            if (f.is_keyframe or f.pose_cw is None or f.ref_kf < 0
                    or not smap.kf_valid[f.ref_kf]):
                continue
            groups.setdefault(int(f.ref_kf), []).append(f)

        n_rematched = 0
        for ref, fs in groups.items():
            ids, _ = smap.covisible_keyframes(ref, min_weight=15)
            kfs = [ref] + [int(k) for k in ids[:10]]
            pts = np.unique(np.concatenate(
                [smap.keyframe_points(k) for k in kfs]))
            pts = pts[smap.pt_valid[pts]][:P]
            if len(pts) < 20:
                continue
            lm, lm_ids = smap.device_mirror(dev).gather(pts, P)
            for start in range(0, len(fs), max_group):
                chunk = fs[start:start + max_group]
                feats = pad_frames_features(chunk, N, dev)
                poses = upload(np.stack([f.pose_cw for f in chunk]).astype(F32),
                               dev)
                fp = HostCopy([M.search_by_projection_fine(
                    lm, feats, poses, self.cam, self.bf, bounds, st,
                    feat_free=feats.valid, th=2.0, ratio=0.9,
                )["feat_point"]]).wait()[0]
                for i, f in enumerate(chunk):
                    assign = fp[i][: f.n].astype(np.int64)
                    matches = np.full(f.n, -1, dtype=np.int64)
                    sel = assign >= 0
                    matches[sel] = lm_ids[assign[sel]]
                    if sel.sum() >= 10:
                        f.matches = matches
                        smap.stamp_matches(f)
                        n_rematched += 1
        return n_rematched
