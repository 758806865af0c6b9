"""Loop closing: detection, Sim3 verification, and global correction.

Counterpart of ``snakeslam_tpu/loop/loop_closing.py`` (the reference's
LoopClosing + LoopDetector + LoopClosingPGO): BoW candidates with an
adaptive min score and temporal consistency, descriptor matching of the
two keyframes' map points, Sim3 registration RANSAC, guided re-search and
robust pose refinement with its gates, then CorrectLoop: the rigid group
correction, the essential-graph PGO, point write-back, duplicate fusion,
SearchAndFuse and the global-BA polish.

Host orchestration around the device pieces: ``ops/sim3_solver``,
``ops/matching.search_by_projection_fine``, the pose refine (on CUDA
tensors the CUDA kernel of ``ops/pose_fused``, on CPU tensors
``ops/pose_solver.robust_pose_refine``) and ``ops/pgo``.  Each verification
step fetches its results in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie, prng
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.loop.keyframe_database import KeyframeDatabase
from snakeslam_tpu_torch.map.slam_map import SlamMap, transform_pose_cw
from snakeslam_tpu_torch.ops import matching as M
from snakeslam_tpu_torch.ops.pgo import PoseGraph, padded, solve_pgo
from snakeslam_tpu_torch.ops.pose_fused import pose_refine_fused
from snakeslam_tpu_torch.ops.pose_solver import PoseObs, robust_pose_refine
from snakeslam_tpu_torch.ops.sim3_solver import sim3_ransac
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.tracking.staging import (HostCopy,
                                                  kf_features_cached,
                                                  snapshot_points, upload)

MIN_LOOP_KF_GAP = 10        # candidate must be this many KFs older
COOLDOWN_KFS = 4            # LoopClosing.cpp:29-59
MIN_SIM3_INLIERS = 20
MIN_POSE_REF_INLIERS = 30   # LoopDetector.cpp:287
MIN_CLOSE_POINTS = 30       # LoopDetector.cpp:310
MIN_SCALE_INLIERS = 15      # LoopDetector.cpp:351
MIN_TOTAL_MATCHES = 40      # LoopDetector.cpp:449


def _verify_search_refine(lm, feat, T0, cam, bf, bounds, st):
    """Guided projection re-search of loop points into the current keyframe
    at the corrected pose + robust pose refinement, 3 x 3 iterations
    (SearchByProjectionFrameToKeyframe(radius 5, th 50) +
    RefinePoseWithMatches).

    Returns (T_refined, assign, inlier_mask, n_inliers, range_m,
    depth_meas) on the device."""
    out = M.search_by_projection_fine(
        lm, feat, T0, cam, bf, bounds, st,
        feat_free=feat.valid, th=5.0, ratio=1.0, feature_error=50,
    )
    assign = out["feat_point"]
    matched = assign >= 0
    P = lm.position.shape[0]
    pts = lm.position[torch.clamp(assign, 0, P - 1).long()]
    weight = (1.0 / st.scales)[torch.clamp(feat.octave, 0,
                                           st.levels - 1).long()]
    if T0.device.type == "cuda":
        T1, inlier, n_inl = pose_refine_fused(
            T0, pts, feat.uv, feat.right, weight, matched, cam, bf,
            outer_iters=3, inner_iters=3)
    else:
        obs = PoseObs(points=pts, uv=feat.uv, right=feat.right,
                      weight=weight, mask=matched)
        T1, inlier, n_inl = robust_pose_refine(
            T0, obs, cam, bf, outer_iters=3, inner_iters=3)
    inlier = inlier & matched
    # range of each matched loop point in the refined frame (the per-point
    # scale consensus uses |pose * p|)
    rng = torch.linalg.norm(lie.transform_points(T1, pts), dim=-1)
    # measured stereo depth for the close-point gate (mono features carry
    # right < 0 -> depth -1, always "close")
    depth_meas = torch.where(
        feat.right > 0,
        bf / torch.clamp(feat.uv[:, 0] - feat.right, min=1e-3),
        torch.full_like(feat.right, -1.0))
    return T1, assign, inlier, n_inl, rng, depth_meas


class LoopClosing:
    def __init__(self, settings: Settings, smap: SlamMap,
                 database: KeyframeDatabase, device, gba=None):
        self.s = settings
        self.map = smap
        self.db = database
        self.gba = gba
        self.device = torch.device(device)
        self.use_scale = settings.input_type == InputType.Mono
        self.last_loop_kf = -COOLDOWN_KFS
        self.prev_candidates: set[int] = set()
        self.consistency_count = 0
        self.n_loops_closed = 0
        self.key = prng.PRNGKey(settings.random_seed + 7)
        self._searcher = None
        dev = self.device
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=dev)
        self.bf = torch.tensor(settings.bf, dtype=torch.float32, device=dev)
        self.bounds = (0.0, 0.0, float(settings.width),
                       float(settings.height))
        self.st = M.ScaleTables.from_pyramid(
            ScalePyramid.create(settings.fd_levels, settings.fd_scale_factor),
            device=dev)

    def _map_searcher(self):
        """Lazily built projection-fusion helper for SearchAndFuse."""
        if self._searcher is None:
            from snakeslam_tpu_torch.mapping.fusion import MapSearcher
            self._searcher = MapSearcher(self.s, self.map, self.device)
        return self._searcher

    # ------------------------------------------------------------------

    def add(self, kf: int):
        self.process(kf)

    def process(self, kf: int):
        """Detect + correct, then register the KF in the database."""
        try:
            if self.map.n_keyframes >= MIN_LOOP_KF_GAP:
                hit = self._detect(kf)
                if hit is not None:
                    cand, s, R, t, pairs = hit
                    self._correct_loop(kf, cand, s, R, t, pairs)
                    self.n_loops_closed += 1
                    self.last_loop_kf = kf
        finally:
            self.db.add(kf)

    # ------------------------------------------------------------------

    def _detect(self, kf: int):
        smap = self.map
        kf_seq = {int(k): i for i, k in enumerate(smap.valid_keyframes())}
        if kf_seq.get(kf, 0) - kf_seq.get(self.last_loop_kf, -10**9) < COOLDOWN_KFS:
            return None

        # adaptive min score: min BoW similarity to the covisible group
        # (LoopDetector.cpp:45-103)
        cov, _ = smap.covisible_keyframes(kf, min_weight=15)
        if len(cov) == 0:
            return None
        v_kf = self.db.vectors[kf] if self.db.present[kf] else None
        w_kf = self.db.words.get(kf)
        if v_kf is None or not v_kf.any():
            n = int(smap.kf_n_feat[kf])
            w_kf, v_kf = self.db.compute_frame_vector(
                smap.kf_feat_desc[kf, :n])
            w_kf = np.unique(w_kf)
        cov_present = [c for c in cov if self.db.present[c]]
        if not cov_present:
            return None
        cov_scores = 1.0 - 0.5 * np.abs(
            v_kf[None] - self.db.vectors[cov_present]
        ).sum(axis=-1)
        min_score = max(float(cov_scores.min()) * 0.8, 0.01)

        # temporal-gap exclusions go in BEFORE the ratio filters so recent
        # keyframes cannot eat the score-ratio budget of true candidates
        too_recent = {
            int(k) for k in smap.valid_keyframes()
            if kf_seq.get(kf, 0) - kf_seq.get(int(k), 0) < MIN_LOOP_KF_GAP
        }
        ids, _ = self.db.detect_loop_candidates(
            kf, min_score, top_n=5, v=v_kf, words=w_kf,
            extra_exclude=too_recent,
        )
        ids = [int(i) for i in ids]
        if not ids:
            self.consistency_count = 0
            self.prev_candidates = set()
            return None

        # temporal consistency >= 2 (LoopDetector.cpp:105-145): a candidate
        # (or its covisible group) must reappear in consecutive detections
        groups = set(ids)
        for i in list(ids):
            c, _ = smap.covisible_keyframes(i, min_weight=15)
            groups |= set(int(x) for x in c)
        consistent = bool(groups & self.prev_candidates)
        self.prev_candidates = groups
        if consistent:
            self.consistency_count += 1
        else:
            self.consistency_count = 1
        if self.consistency_count < 2:
            return None

        # geometric verification against the best candidates
        for cand in ids[:3]:
            hit = self._compute_sim3(kf, int(cand))
            if hit is not None:
                return (int(cand),) + hit
        return None

    def _compute_sim3(self, kf: int, cand: int):
        """Match map points of the two KFs, register Sim3
        (LoopDetector::ComputeSim3)."""
        smap = self.map
        pairs = self._match_points(kf, cand)
        if pairs is None or len(pairs[0]) < MIN_SIM3_INLIERS:
            return None
        pts_new, pts_old = pairs  # current-side / loop-side point ids
        dev = self.device
        self.key, sub = prng.split(self.key)
        scene_scale = max(float(smap.kf_median_depth[kf]), 1.0)
        # padded to a multiple of 256 pairs, as the JAX package pads them:
        # the hypotheses are drawn over the padded shape
        npairs = len(pts_new)
        pad = -(-npairs // 256) * 256
        src = np.zeros((pad, 3), dtype=np.float32)
        src[:npairs] = smap.pt_pos[pts_new]
        dst = np.zeros((pad, 3), dtype=np.float32)
        dst[:npairs] = smap.pt_pos[pts_old]
        mask = upload(np.arange(pad) < npairs, dev)
        s, R, t, inl, n = sim3_ransac(
            upload(src, dev), upload(dst, dev), mask,
            prng.sample_without_replacement(sub, mask, 128, 3),
            threshold=0.05 * scene_scale, with_scale=self.use_scale)
        s, R, t, inl, n = HostCopy([s, R, t, inl, n]).wait()   # one copy
        if int(n) < MIN_SIM3_INLIERS:
            return None
        inl = inl[:npairs]
        return self._verify_sim3(
            kf, cand, float(s), R.astype(np.float64), t.astype(np.float64),
            (pts_new[inl], pts_old[inl]))

    def _verify_sim3(self, kf: int, cand: int, s: float, R: np.ndarray,
                     t: np.ndarray, ransac_pairs):
        """Geometric verification of a RANSAC Sim3 hypothesis
        (LoopDetector.cpp:262-374): guided projection re-search of the loop
        keyframe's points into the current keyframe at the corrected pose,
        pose refinement with >= 30 inliers, a close-point count gate, robust
        per-point scale re-estimation (mono), and a total-match gate.
        Returns the refined (s, R, t, pairs) or None when any gate fails."""
        smap = self.map
        dev = self.device
        T_kf = smap.kf_pose[kf]
        T_corr = transform_pose_cw(T_kf, s, R, t)

        # loop-side points observed by the candidate keyframe
        loop_pts = smap.keyframe_points(cand)
        loop_pts = loop_pts[smap.pt_valid[loop_pts]]
        if len(loop_pts) < MIN_POSE_REF_INLIERS:
            return None
        if getattr(self.s, "pin_local_map_bucket", False):
            bucket = self.s.local_map_slots  # one snapshot shape
        else:
            bucket = 512
            while bucket < min(len(loop_pts), self.s.local_map_slots):
                bucket *= 2
        lm, lm_ids = snapshot_points(smap, loop_pts, bucket, dev)
        feat = kf_features_cached(smap, kf, self.s.feature_slots, dev)

        out = _verify_search_refine(
            lm, feat, upload(T_corr.astype(np.float32), dev),
            self.cam, self.bf, self.bounds, self.st)
        T1, assign, inlier, n_inl, rng, depth_meas = HostCopy(out).wait()
        if int(n_inl) < MIN_POSE_REF_INLIERS:
            return None
        nf = int(smap.kf_n_feat[kf])
        inlier = inlier[:nf]
        assign = assign[:nf]
        rng = rng[:nf]
        depth_meas = depth_meas[:nf]

        # close-point gate (LoopDetector.cpp:292-314): mono depth_meas = -1
        # always counts close; stereo needs measured depth <= th_depth
        th_depth = float(self.s.th_depth) if self.s.th_depth > 0 else np.inf
        if int(np.sum(inlier & (depth_meas <= th_depth))) < MIN_CLOSE_POINTS:
            return None
        if int(inlier.sum()) < MIN_TOTAL_MATCHES:
            return None

        s_out = s
        if self.use_scale:
            # robust per-point scale consensus (LoopDetector.cpp:317-357):
            # features with BOTH a current-map observation and a matched
            # loop point vote point_scale = |T1 p_loop| / |T_kf p_cur|
            cur_obs = smap.kf_obs[kf, :nf]
            has_cur = (cur_obs >= 0) & smap.pt_valid[np.maximum(cur_obs, 0)]
            vote = inlier & has_cur
            if not vote.any():
                return None
            p_cur = smap.pt_pos[cur_obs[vote]]
            z2 = np.linalg.norm(p_cur @ T_kf[:3, :3].T + T_kf[:3, 3], axis=-1)
            point_scale = rng[vote] / np.maximum(z2, 1e-9)
            rel = (np.abs(point_scale - s)
                   / np.maximum(np.abs(point_scale), abs(s)))
            good = rel < 0.1
            if int(good.sum()) < MIN_SCALE_INLIERS:
                return None
            s_out = float(point_scale[good].mean())

        # recover the world similarity that maps the refined pose:
        # transform_pose_cw(T_kf, s', R', t') == T1
        T1 = np.asarray(T1, dtype=np.float64)
        Rn = T1[:3, :3]
        R_out = Rn.T @ T_kf[:3, :3]
        t_out = Rn.T @ (s_out * T_kf[:3, 3] - T1[:3, 3])

        # fusion pairs from the re-search: current-side point <-> loop point
        cur_obs = smap.kf_obs[kf, :nf]
        has_cur = (cur_obs >= 0) & smap.pt_valid[np.maximum(cur_obs, 0)]
        pair_sel = inlier & has_cur
        pts_new = cur_obs[pair_sel]
        pts_old = lm_ids[assign[pair_sel]]
        if len(pts_new) < 3:
            pts_new, pts_old = ransac_pairs
        return (s_out, R_out, t_out, (pts_new, pts_old))

    def _match_points(self, kf: int, cand: int):
        """Descriptor matching between the two KFs' observed map points
        (host popcount: one small pair per call)."""
        smap = self.map

        def kf_points(k):
            n = int(smap.kf_n_feat[k])
            feats = np.nonzero(smap.kf_obs[k, :n] >= 0)[0]
            pts = smap.kf_obs[k, feats]
            ok = smap.pt_valid[pts]
            return pts[ok], smap.kf_feat_desc[k, feats[ok]]

        pts_a, desc_a = kf_points(kf)
        pts_b, desc_b = kf_points(cand)
        if len(pts_a) < 20 or len(pts_b) < 20:
            return None
        idx, _ = M.knn2_ratio_match_packed_np(desc_a, desc_b, ratio=0.75,
                                              max_dist=50)
        sel = idx >= 0
        return pts_a[sel], pts_b[idx[sel]]

    # ------------------------------------------------------------------

    def _correct_loop(self, kf: int, cand: int, s, R, t, pairs):
        """CorrectLoop (LoopClosing.cpp:184-447): rigid+scale correction of
        the current side, point fusion, essential-graph PGO, global BA."""
        smap = self.map
        state_before = smap.state

        kfs = smap.valid_keyframes()
        kfs = kfs[np.argsort(smap.kf_frame_id[kfs])]
        kf_index = {int(k): i for i, k in enumerate(kfs)}
        V = len(kfs)

        # corrected pose of the current keyframe under the world similarity
        # x_old = s R x_new + t applied to the current side
        T_kf_corr = transform_pose_cw(smap.kf_pose[kf], s, R, t)

        # ---- build the essential graph from PRE-correction poses ----
        edges = []
        for i, k in enumerate(kfs):
            prev = smap.kf_prev[k]
            if prev >= 0 and smap.kf_valid[prev]:
                Mk = smap.kf_pose[k] @ np.linalg.inv(smap.kf_pose[prev])
                edges.append((kf_index[int(prev)], i, Mk, 1.0))
            cov, w = smap.covisible_keyframes(int(k), min_weight=20)
            for c, _ in zip(cov[:10], w[:10]):
                if int(c) < int(k):
                    Mk = smap.kf_pose[k] @ np.linalg.inv(smap.kf_pose[c])
                    edges.append((kf_index[int(c)], i, Mk, 0.5))
        # the loop edge ties cand to the corrected current keyframe
        M_loop = T_kf_corr @ np.linalg.inv(smap.kf_pose[cand])
        edges.append((kf_index[cand], kf_index[kf], M_loop, 4.0))

        use_sim3 = self.use_scale
        poses = smap.kf_pose[kfs].copy()

        # rigidly pre-correct the current covisible group by the measured
        # similarity (LoopClosing.cpp:242-263), then hold both loop
        # endpoints constant in the graph optimization
        group, _ = smap.covisible_keyframes(kf, min_weight=15)
        group = set(int(g) for g in group) | {kf}
        for g in group:
            poses[kf_index[g]] = transform_pose_cw(smap.kf_pose[g], s, R, t)
        fixed = np.zeros(V, dtype=bool)
        fixed[kf_index[cand]] = True
        fixed[kf_index[kf]] = True

        # float64 on either device (the H100 runs f64 at full rate),
        # padded to power-of-two sizes: the compiled solve's key repeats
        dev = self.device
        graph = PoseGraph(**{k: upload(a, dev) for k, a in padded(
            poses.astype(np.float64), fixed,
            np.array([e[0] for e in edges], np.int64),
            np.array([e[1] for e in edges], np.int64),
            np.stack([e[2] for e in edges]).astype(np.float64),
            np.array([e[3] for e in edges], np.float64)).items()})
        new_poses, _ = solve_pgo(graph, iterations=25, use_sim3=use_sim3)
        new_poses = HostCopy([new_poses]).wait()[0][:V]

        if smap.state != state_before:
            return

        # ---- write back: poses + points via their reference KF ----
        # each point moves by its reference keyframe's before->after
        # similarity (LoopClosingPGO.cpp:152-263)
        old_poses = smap.kf_pose[kfs].copy()
        scales = (np.linalg.norm(new_poses[:, 0, :3], axis=-1)
                  if use_sim3 else np.ones(V))
        for i, k in enumerate(kfs):
            P = new_poses[i]
            if use_sim3:
                P = P.copy()
                P[:3, :3] = P[:3, :3] / scales[i]
                P[:3, 3] = P[:3, 3] / scales[i]
            smap.kf_pose[k] = P
        # transform points: x' = T_new^-1_se3 * (s_ref * (T_old * x))
        pts = smap.valid_points()
        ref = smap.pt_ref_kf[pts]
        ref_ok = (ref >= 0) & smap.kf_valid[np.maximum(ref, 0)]
        ref_rows = np.array([kf_index.get(int(r), -1) for r in ref])
        usable = ref_ok & (ref_rows >= 0)
        rows = ref_rows[usable]
        p_sel = pts[usable]
        To = old_poses[rows]
        Tn = smap.kf_pose[np.asarray(ref[usable], dtype=int)]
        x = smap.pt_pos[p_sel]
        xc = np.einsum("nij,nj->ni", To[:, :3, :3], x) + To[:, :3, 3]
        xc = xc / scales[rows][:, None]  # undo scale drift in camera space
        x_new = np.einsum("nji,nj->ni", Tn[:, :3, :3], xc - Tn[:, :3, 3])
        smap.pt_pos[p_sel] = x_new
        smap.state += 1

        # ---- fuse duplicate loop points ----
        pts_new, pts_old = pairs
        for a, b in zip(pts_new, pts_old):
            if smap.pt_valid[a] and smap.pt_valid[b] and a != b:
                smap.replace_point(int(a), int(b))

        # ---- SearchAndFuse (LoopClosing.cpp:141-145): project each
        # side's map points into the other side's (now-corrected)
        # keyframes and merge every duplicate, so the two sides share
        # observations before the final BA
        searcher = self._map_searcher()
        cand_group, _ = smap.covisible_keyframes(cand, min_weight=15)
        cand_group = set(int(g) for g in cand_group) | {cand}

        def side_points(kf_set):
            out = [smap.keyframe_points(int(g)) for g in kf_set]
            if not out:
                return np.array([], dtype=np.int64)
            pts = np.unique(np.concatenate(out))
            return pts[smap.pt_valid[pts]]

        cur_pts = side_points(group)
        loop_pts = side_points(cand_group)
        for g in group:
            searcher._fuse_points_into_kf(loop_pts, int(g), th=4.0)
        for g in cand_group:
            searcher._fuse_points_into_kf(cur_pts, int(g), th=4.0)
        smap.update_points_bulk(np.concatenate([cur_pts, loop_pts]))

        # ---- final polish (RunGBA, LoopClosing.cpp:517-560): a point-only
        # pass makes the points consistent with the pose-graph solution, the
        # outlier prune drops the cross-seam observations that still
        # disagree, then the joint BA
        if self.gba is not None:
            self.gba.point_ba(iterations=10)
            self.gba.remove_outliers()
            self.gba.full_ba(iterations=3)
