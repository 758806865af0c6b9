"""The global map: fixed-capacity keyframe/point pools over numpy arrays.

Host-authoritative replacement for the reference's ``Map`` singleton with its
preallocated ``FixedVectorHeap`` pools (reference: Snake/Map/Map.h:213-214,
48-77 — id == pool index) and the ``Keyframe``/``MapPoint`` records
(Snake/Map/Keyframe.h:20, Snake/Map/MapPoint.h:17).

Structure-of-arrays layout so that device snapshots (local maps, BA problems)
are cheap vectorized gathers.  The reference's concurrency protocol
(shared_mutex + generation counter, Map.h:139-148) maps onto a single
``state`` generation counter here; in deterministic mode all mutation is
single-threaded, and async back-ends use snapshot-compute-commit with a
conflict check on ``state`` (like LocalBundleAdjustment.cpp:470-474).

Observations are stored twice, kept in sync by add/remove_observation:
  * forward:  kf_obs[kf, feature_slot] -> point id (or -1)
  * reverse:  pt_obs_kf/pt_obs_feat[point, slot] (bounded MAX_OBS slots)
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

MAX_OBS = 24  # per-point observation slots (reference points rarely exceed
              # ~15 observers after keyframe simplification)


@dataclass
class FrameData:
    """Feature-level input frame (output of the preprocessing front-end)."""

    frame_id: int
    timestamp: float
    uv: np.ndarray           # (n, 2) undistorted pixel coords
    octave: np.ndarray       # (n,)
    angle: np.ndarray        # (n,) degrees
    descriptors: np.ndarray  # (n, 32) packed uint8
    right: np.ndarray        # (n,) right-image x or -1
    depth: np.ndarray        # (n,) metric depth or -1
    gt_pose_cw: np.ndarray | None = None  # (4,4) ground truth (eval only)

    # IMU samples covering (previous frame, this frame]
    imu_omega: np.ndarray | None = None   # (s, 3) rad/s
    imu_acc: np.ndarray | None = None     # (s, 3) m/s^2
    imu_dt: np.ndarray | None = None      # (s,)
    imu_t: np.ndarray | None = None       # (s,) sample start times
    imu_dR_cam: np.ndarray | None = None  # (3,3) gyro-predicted camera dR

    # tracking state (filled by the tracker)
    pose_cw: np.ndarray | None = None     # (4, 4) world->camera
    matches: np.ndarray | None = None     # (n,) point id or -1
    outlier: np.ndarray | None = None     # (n,) bool
    ref_kf: int = -1
    is_keyframe: bool = False
    # pose relative to the reference keyframe, T_cw = rel_to_ref @ T_ref
    # (reference: Frame.h:94-98 reltoRef + Frame.cpp:67-71
    # getPoseFromReference) — keyframe corrections (LBA drift, loop
    # closure PGO) retroactively correct the whole frame trajectory.
    # ref_frame_id guards against keyframe-slot reuse: a culled slot can
    # be reallocated to an unrelated keyframe (id == pool index), so the
    # composition is valid only while the slot still holds the SAME
    # keyframe (its source frame_id matches).
    rel_to_ref: np.ndarray | None = None  # (4, 4)
    ref_frame_id: int = -1

    @property
    def n(self) -> int:
        return len(self.uv)

    def capture_rel(self, kf_pose_cw: np.ndarray, ref_frame_id: int = -1):
        """Record the pose relative to the reference keyframe (call with
        the reference keyframe's pose AS OF tracking time)."""
        if self.pose_cw is not None:
            self.rel_to_ref = self.pose_cw @ np.linalg.inv(kf_pose_cw)
            self.ref_frame_id = int(ref_frame_id)


class SlamMap:
    """Fixed-capacity global map."""

    def __init__(self, max_keyframes: int = 2048, max_points: int = 262144,
                 max_features: int = 1024):
        K, P, N = max_keyframes, max_points, max_features
        self.max_keyframes = K
        self.max_points = P
        self.max_features = N

        # --- keyframes ---
        self.kf_valid = np.zeros(K, dtype=bool)
        self.kf_pose = np.tile(np.eye(4), (K, 1, 1))     # world->camera
        self.kf_timestamp = np.zeros(K)
        self.kf_frame_id = np.full(K, -1, dtype=np.int64)
        self.kf_prev = np.full(K, -1, dtype=np.int32)    # temporal chain
        self.kf_next = np.full(K, -1, dtype=np.int32)
        self.kf_parent = np.full(K, -1, dtype=np.int32)  # spanning tree
        self.kf_cull_factor = np.ones(K, dtype=np.float32)
        self.kf_median_depth = np.zeros(K, dtype=np.float64)
        self.kf_velocity = np.zeros((K, 3))
        self.kf_bias_gyro = np.zeros((K, 3))
        self.kf_bias_acc = np.zeros((K, 3))
        self.kf_n_feat = np.zeros(K, dtype=np.int32)
        self.kf_obs = np.full((K, N), -1, dtype=np.int32)
        self.kf_feat_uv = np.zeros((K, N, 2), dtype=np.float32)
        self.kf_feat_right = np.full((K, N), -1.0, dtype=np.float32)
        self.kf_feat_depth = np.full((K, N), -1.0, dtype=np.float32)
        self.kf_feat_octave = np.zeros((K, N), dtype=np.int8)
        self.kf_feat_angle = np.zeros((K, N), dtype=np.float32)
        self.kf_feat_desc = np.zeros((K, N, 32), dtype=np.uint8)

        # --- points ---
        self.pt_valid = np.zeros(P, dtype=bool)
        self.pt_pos = np.zeros((P, 3))
        self.pt_normal = np.zeros((P, 3), dtype=np.float32)
        self.pt_desc = np.zeros((P, 32), dtype=np.uint8)
        # unpacked bit planes, kept in sync with pt_desc (device staging
        # slices this directly instead of re-unpacking per snapshot)
        self.pt_bits = np.zeros((P, 256), dtype=np.int8)
        self.pt_ref_kf = np.full(P, -1, dtype=np.int32)
        self.pt_ref_depth = np.zeros(P, dtype=np.float32)
        self.pt_ref_level = np.zeros(P, dtype=np.int8)
        self.pt_found = np.zeros(P, dtype=np.int32)
        self.pt_visible = np.zeros(P, dtype=np.int32)
        self.pt_first_kf = np.full(P, -1, dtype=np.int32)
        self.pt_obs_kf = np.full((P, MAX_OBS), -1, dtype=np.int32)
        self.pt_obs_feat = np.full((P, MAX_OBS), -1, dtype=np.int32)
        self.pt_n_obs = np.zeros(P, dtype=np.int32)
        # observation-set change flag: the distinctive-descriptor / normal
        # recompute (update_points_bulk) only needs to run for points whose
        # observations changed since the last update — the reference calls
        # UpdateDistinctiveDescriptors/UpdateNormalAndDepth on modification
        # (MapPoint.cpp:60-81,120-166), not per back-end cycle
        self.pt_dirty = np.zeros(P, dtype=bool)
        # per-slot allocation generation: point slots are recycled
        # (id == pool index), so a stale slot->id translation from an
        # in-flight device snapshot can silently alias a NEW point after
        # erase+reallocate.  The reference's shared_ptr identity makes this
        # impossible (a dead MapPoint keeps its object, Map.h:48-77); the
        # SoA analog is a generation stamp checked at consume time.
        self.pt_alloc_gen = np.zeros(P, dtype=np.int64)

        self._next_kf = 0
        self._next_pt = 0
        self._free_pts: list[int] = []
        self._free_kfs: list[int] = []
        self.state = 0  # generation counter (Map.h:139 mapState analog)
        self.lock = threading.RLock()
        # callbacks invoked after a whole-map Sim3 transform with (s, R, t) —
        # the reference avoids this by storing frame poses relative to their
        # reference keyframe (Frame.h:94-98); with absolute storage the
        # tracker must rebase its state explicitly
        self.on_transform: list = []
        self.on_erase_keyframe: list = []
        # culled keyframes: source frame_id -> (anchor slot, anchor source
        # frame_id, T_culled @ T_anchor^-1) for gauge-consistent global
        # poses (Keyframe::PoseGlobal parity, Keyframe.cpp:612-625)
        self.erased_kf_rel: dict[int, tuple[int, int, np.ndarray]] = {}

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------

    def allocate_keyframe(self, frame: FrameData) -> int:
        if self._free_kfs:
            k = self._free_kfs.pop()
        else:
            k = self._next_kf
            self._next_kf += 1
            if k >= self.max_keyframes:
                raise RuntimeError("keyframe pool exhausted")
        n = frame.n
        self.kf_valid[k] = True
        self.kf_pose[k] = frame.pose_cw
        self.kf_timestamp[k] = frame.timestamp
        self.kf_frame_id[k] = frame.frame_id
        self.kf_prev[k] = -1
        self.kf_next[k] = -1
        self.kf_parent[k] = -1
        self.kf_cull_factor[k] = 1.0
        self.kf_n_feat[k] = n
        self.kf_obs[k] = -1
        self.kf_feat_uv[k, :n] = frame.uv
        self.kf_feat_right[k] = -1.0
        self.kf_feat_right[k, :n] = frame.right
        self.kf_feat_depth[k] = -1.0
        self.kf_feat_depth[k, :n] = frame.depth
        self.kf_feat_octave[k, :n] = frame.octave
        self.kf_feat_angle[k, :n] = frame.angle
        self.kf_feat_desc[k, :n] = frame.descriptors
        self.state += 1
        return k

    def allocate_point(self, pos, desc, ref_kf: int, ref_depth: float,
                       ref_level: int, normal) -> int:
        if self._free_pts:
            p = self._free_pts.pop()
        else:
            p = self._next_pt
            self._next_pt += 1
            if p >= self.max_points:
                raise RuntimeError("point pool exhausted")
        self.pt_valid[p] = True
        self.pt_pos[p] = pos
        self.pt_normal[p] = normal
        self.pt_desc[p] = desc
        self.pt_bits[p] = np.unpackbits(
            np.asarray(desc, dtype=np.uint8), bitorder="little"
        )
        self.pt_ref_kf[p] = ref_kf
        self.pt_ref_depth[p] = ref_depth
        self.pt_ref_level[p] = ref_level
        self.pt_found[p] = 1
        self.pt_visible[p] = 1
        self.pt_first_kf[p] = ref_kf
        self.pt_obs_kf[p] = -1
        self.pt_obs_feat[p] = -1
        self.pt_n_obs[p] = 0
        self.pt_dirty[p] = True
        self.pt_alloc_gen[p] += 1
        return p

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------

    def add_observation(self, kf: int, feat: int, pt: int) -> bool:
        """Link keyframe feature slot -> point. Returns False on slot
        overflow (observation dropped)."""
        old = self.kf_obs[kf, feat]
        if old == pt:
            return True
        if old >= 0:
            self.remove_observation(kf, feat)
        slots = self.pt_obs_kf[pt]
        free = np.nonzero(slots < 0)[0]
        if len(free) == 0:
            return False
        s = free[0]
        self.pt_obs_kf[pt, s] = kf
        self.pt_obs_feat[pt, s] = feat
        self.pt_n_obs[pt] += 1
        self.kf_obs[kf, feat] = pt
        self.pt_dirty[pt] = True
        return True

    def remove_observation(self, kf: int, feat: int):
        pt = self.kf_obs[kf, feat]
        if pt < 0:
            return
        self.kf_obs[kf, feat] = -1
        self.pt_dirty[pt] = True
        sel = np.nonzero(
            (self.pt_obs_kf[pt] == kf) & (self.pt_obs_feat[pt] == feat)
        )[0]
        for s_idx in sel[::-1]:
            # keep the slot array dense (swap-with-last) so bulk insertion
            # can write at slot pt_n_obs directly
            last = self.pt_n_obs[pt] - 1
            self.pt_obs_kf[pt, s_idx] = self.pt_obs_kf[pt, last]
            self.pt_obs_feat[pt, s_idx] = self.pt_obs_feat[pt, last]
            self.pt_obs_kf[pt, last] = -1
            self.pt_obs_feat[pt, last] = -1
            self.pt_n_obs[pt] = last

    def add_observations_bulk(self, kf: int, feats: np.ndarray,
                              pts: np.ndarray) -> np.ndarray:
        """Vectorized add_observation for NEW (kf, feat, pt) links: every
        point must not already observe this keyframe and the feature slots
        must be free.  Returns a mask of successfully linked entries."""
        feats = np.asarray(feats)
        pts = np.asarray(pts)
        if not self.kf_valid[kf]:
            # one-cycle-stale back-end commits (pipelined flush) may target
            # a keyframe that simplification culled after their dispatch —
            # linking observations to a dead keyframe corrupts covisibility
            return np.zeros(len(feats), dtype=bool)
        slots = self.pt_n_obs[pts]
        ok = (slots < MAX_OBS) & self.pt_valid[pts]
        # observation slots are kept dense, so slot == n_obs
        f_ok = feats[ok]
        p_ok = pts[ok]
        s_ok = slots[ok]
        self.kf_obs[kf, f_ok] = p_ok
        self.pt_obs_kf[p_ok, s_ok] = kf
        self.pt_obs_feat[p_ok, s_ok] = f_ok
        self.pt_n_obs[p_ok] = s_ok + 1
        self.pt_dirty[p_ok] = True
        return ok

    def allocate_points_bulk(self, positions, descs, ref_kf: int,
                             ref_depths, ref_levels, normals) -> np.ndarray:
        """Vectorized allocate_point for n new points (contiguous ids)."""
        n = len(positions)
        ids = np.empty(n, dtype=np.int64)
        n_free = min(len(self._free_pts), n)
        for i in range(n_free):
            ids[i] = self._free_pts.pop()
        n_new = n - n_free
        if n_new:
            if self._next_pt + n_new > self.max_points:
                raise RuntimeError("point pool exhausted")
            ids[n_free:] = np.arange(self._next_pt, self._next_pt + n_new)
            self._next_pt += n_new
        self.pt_valid[ids] = True
        self.pt_pos[ids] = positions
        self.pt_normal[ids] = normals
        self.pt_desc[ids] = descs
        self.pt_bits[ids] = np.unpackbits(
            np.asarray(descs, dtype=np.uint8), axis=1, bitorder="little"
        )
        self.pt_ref_kf[ids] = ref_kf
        self.pt_ref_depth[ids] = ref_depths
        self.pt_ref_level[ids] = ref_levels
        self.pt_found[ids] = 1
        self.pt_visible[ids] = 1
        self.pt_first_kf[ids] = ref_kf
        self.pt_obs_kf[ids] = -1
        self.pt_obs_feat[ids] = -1
        self.pt_n_obs[ids] = 0
        self.pt_dirty[ids] = True
        self.pt_alloc_gen[ids] += 1
        return ids

    def update_points_bulk(self, pts: np.ndarray, only_dirty: bool = False):
        """Vectorized distinctive-descriptor + viewing-normal update for a
        batch of points (MapPoint.cpp:60-81,120-166 semantics).

        With ``only_dirty=True`` the batch is narrowed to points whose
        observation set actually changed since their last update — the
        per-KF-cycle caller passes every point the keyframe sees, but most
        were updated in earlier cycles and are untouched since."""
        pts = np.asarray(pts)
        if only_dirty and len(pts):
            pts = pts[self.pt_dirty[pts]]
        if len(pts) == 0:
            return
        okf = self.pt_obs_kf[pts]            # (n, MAX_OBS)
        ofe = self.pt_obs_feat[pts]
        valid = okf >= 0
        # compress to the observation slots actually in use: points carry
        # far fewer observations than the MAX_OBS padding, and the pairwise
        # Hamming below is quadratic in the slot count
        used_cols = np.nonzero(valid.any(axis=0))[0]
        if len(used_cols) == 0:
            return
        okf = okf[:, used_cols]
        ofe = ofe[:, used_cols]
        valid = valid[:, used_cols]
        M = len(used_cols)
        k = np.maximum(okf, 0)
        f = np.maximum(ofe, 0)
        # ---- distinctive descriptor: min median pairwise Hamming ----
        # pairwise popcount on PACKED words: view the 32 descriptor bytes as
        # 4 uint64 lanes and use the hardware popcount (np.bitwise_count) —
        # (n, M, M, 4) word ops instead of a (n, M, M, 32) byte-LUT gather
        packed = np.ascontiguousarray(self.kf_feat_desc[k, f])  # (n, M, 32)
        p64 = packed.view(np.uint64)                 # (n, M, 4)
        x = p64[:, :, None, :] ^ p64[:, None, :, :]
        dist = np.bitwise_count(x).sum(axis=-1, dtype=np.int32)  # (n, M, M)
        pair_ok = valid[:, :, None] & valid[:, None, :]
        dist = np.where(pair_ok, dist, 9999)
        dist_sorted = np.sort(dist, axis=2)
        counts = valid.sum(axis=1)
        med_idx = np.maximum((counts - 1) // 2, 0)
        med = np.take_along_axis(
            dist_sorted, med_idx[:, None, None].repeat(M, axis=1),
            axis=2,
        )[:, :, 0].astype(np.float64)
        med = np.where(valid, med, np.inf)
        best = med.argmin(axis=1)
        rows = np.arange(len(pts))
        self.pt_desc[pts] = self.kf_feat_desc[k[rows, best], f[rows, best]]
        self.pt_bits[pts] = np.unpackbits(
            self.pt_desc[pts], axis=-1, bitorder="little"
        ).astype(np.int8)
        # ---- viewing normal ----
        T = self.kf_pose[k]                   # (n, M, 4, 4)
        centers = -np.einsum("nmij,nmj->nmi",
                             T[:, :, :3, :3].transpose(0, 1, 3, 2),
                             T[:, :, :3, 3])
        normals = centers - self.pt_pos[pts][:, None, :]
        norms = np.linalg.norm(normals, axis=2, keepdims=True)
        normals = np.where(valid[:, :, None],
                           normals / np.maximum(norms, 1e-9), 0.0)
        mean_n = normals.sum(axis=1) / np.maximum(counts[:, None], 1)
        mn = np.linalg.norm(mean_n, axis=1, keepdims=True)
        self.pt_normal[pts] = mean_n / np.maximum(mn, 1e-9)
        # ---- reference depth/level ----
        ref = self.pt_ref_kf[pts]
        is_ref = (okf == ref[:, None]) & valid
        has_ref = is_ref.any(axis=1)
        ref_col = is_ref.argmax(axis=1)
        Tr = self.kf_pose[np.maximum(ref, 0)]
        cam_c = -np.einsum("nij,nj->ni", Tr[:, :3, :3].transpose(0, 2, 1),
                           Tr[:, :3, 3])
        d = np.linalg.norm(self.pt_pos[pts] - cam_c, axis=1)
        self.pt_ref_depth[pts[has_ref]] = d[has_ref]
        self.pt_ref_level[pts[has_ref]] = self.kf_feat_octave[
            np.maximum(ref[has_ref], 0), f[rows[has_ref], ref_col[has_ref]]
        ]
        self.pt_dirty[pts] = False

    def point_observations(self, pt: int):
        """(kf_ids, feat_slots) arrays for a point's live observations."""
        sel = self.pt_obs_kf[pt] >= 0
        return self.pt_obs_kf[pt, sel], self.pt_obs_feat[pt, sel]

    # ------------------------------------------------------------------
    # removal (SetBadFlag analogs)
    # ------------------------------------------------------------------

    def erase_point(self, pt: int):
        """MapPoint::SetBadFlag (reference: Snake/Map/MapPoint.cpp:84-103)."""
        if not self.pt_valid[pt]:
            return
        kfs, feats = self.point_observations(pt)
        for k, f in zip(kfs, feats):
            self.kf_obs[k, f] = -1
        self.pt_obs_kf[pt] = -1
        self.pt_obs_feat[pt] = -1
        self.pt_n_obs[pt] = 0
        self.pt_valid[pt] = False
        self.pt_dirty[pt] = False
        self._free_pts.append(pt)
        self.state += 1

    def erase_keyframe(self, kf: int):
        """Keyframe::SetBadFlag graph surgery (reference:
        Snake/Map/Keyframe.cpp:456-601): drop observations, splice the
        temporal chain, reparent spanning-tree children."""
        if not self.kf_valid[kf]:
            return
        for cb in self.on_erase_keyframe:
            cb(int(kf))
        n = self.kf_n_feat[kf]
        for f in np.nonzero(self.kf_obs[kf, :n] >= 0)[0]:
            pt = self.kf_obs[kf, f]
            self.remove_observation(kf, int(f))
            if self.pt_n_obs[pt] <= 1 and self.pt_ref_kf[pt] == kf:
                # point's reference died with <=1 obs: drop the point
                self.erase_point(int(pt))
            elif self.pt_ref_kf[pt] == kf:
                self.pt_ref_kf[pt] = self.pt_obs_kf[pt][
                    self.pt_obs_kf[pt] >= 0
                ][0]
        prev, nxt = self.kf_prev[kf], self.kf_next[kf]
        if prev >= 0:
            self.kf_next[prev] = nxt
        if nxt >= 0:
            self.kf_prev[nxt] = prev
        # reparent children to this KF's parent
        children = np.nonzero(self.kf_parent == kf)[0]
        self.kf_parent[children] = self.kf_parent[kf]
        # record the pose relative to a surviving anchor so culled-KF
        # global poses can follow later corrections (Keyframe::PoseGlobal
        # walks spanning-tree parents, Keyframe.cpp:612-625).  Keyed by the
        # keyframe's source frame_id — slots get reused.
        # force-culled keyframes (cull_factor >= 5, the bad-section
        # mitigation marker, System.cpp:167-184) are culled BECAUSE their
        # pose is suspect — recording an anchor rel from it would make
        # frames compose through the very corruption the cull removed
        anchor = nxt if (nxt >= 0 and self.kf_valid[nxt]) else prev
        if (anchor >= 0 and self.kf_valid[anchor]
                and self.kf_cull_factor[kf] < 5.0):
            rel = self.kf_pose[kf] @ np.linalg.inv(self.kf_pose[anchor])
            self.erased_kf_rel[int(self.kf_frame_id[kf])] = (
                int(anchor), int(self.kf_frame_id[anchor]), rel)
        self.kf_valid[kf] = False
        if hasattr(self, "_kf_feat_cache"):
            self._kf_feat_cache.pop(kf, None)
        self._free_kfs.append(kf)
        self.state += 1

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def valid_keyframes(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def valid_points(self) -> np.ndarray:
        return np.nonzero(self.pt_valid)[0]

    @property
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def keyframe_points(self, kf: int) -> np.ndarray:
        """Point ids observed by a keyframe."""
        obs = self.kf_obs[kf, : self.kf_n_feat[kf]]
        return np.unique(obs[obs >= 0])

    def covisible_keyframes(self, kf: int, min_weight: int = 15):
        """(kf_ids, weights) of keyframes sharing >= min_weight points,
        sorted by weight descending (reference: Keyframe::UpdateConnections,
        Snake/Map/Keyframe.cpp:89-171)."""
        pts = self.keyframe_points(kf)
        if len(pts) == 0:
            return np.array([], dtype=np.int32), np.array([], dtype=np.int32)
        obs_kfs = self.pt_obs_kf[pts].ravel()
        obs_kfs = obs_kfs[(obs_kfs >= 0) & (obs_kfs != kf)]
        if len(obs_kfs) == 0:
            return np.array([], dtype=np.int32), np.array([], dtype=np.int32)
        counts = np.bincount(obs_kfs, minlength=self.max_keyframes)
        counts *= self.kf_valid  # stale one-cycle-lag commits can reference
        #                          a just-culled keyframe; never surface it
        ids = np.nonzero(counts >= min_weight)[0]
        if len(ids) == 0:
            # fall back to the single best neighbor (reference keeps the max
            # edge even below threshold, Keyframe.cpp:120-135)
            best = int(np.argmax(counts))
            if counts[best] == 0:
                return (np.array([], dtype=np.int32),
                        np.array([], dtype=np.int32))
            ids = np.array([best])
        w = counts[ids]
        order = np.argsort(-w)
        return ids[order].astype(np.int32), w[order].astype(np.int32)

    def update_spanning_tree_parent(self, kf: int):
        """Parent = strongest covisible KF older than kf (Keyframe.cpp:144-160)."""
        ids, w = self.covisible_keyframes(kf, min_weight=1)
        older = ids[self.kf_frame_id[ids] < self.kf_frame_id[kf]]
        if len(older) > 0:
            self.kf_parent[kf] = older[0]

    def compute_median_depth(self, kf: int) -> float:
        """Median depth of the KF's observed points (Keyframe.cpp:175-206)."""
        pts = self.keyframe_points(kf)
        if len(pts) == 0:
            return 0.0
        T = self.kf_pose[kf]
        z = (self.pt_pos[pts] @ T[:3, :3].T + T[:3, 3])[:, 2]
        z = z[z > 0]
        med = float(np.median(z)) if len(z) else 0.0
        self.kf_median_depth[kf] = med
        return med

    def update_point_descriptor_and_normal(self, pt: int):
        """Distinctive descriptor (min median Hamming, MapPoint.cpp:60-81)
        + viewing normal (MapPoint.cpp:120-166)."""
        kfs, feats = self.point_observations(pt)
        if len(kfs) == 0:
            return
        descs = self.kf_feat_desc[kfs, feats]  # (n, 32)
        if len(descs) > 2:
            bits = np.unpackbits(descs, axis=1)
            dist = (bits[:, None, :] != bits[None, :, :]).sum(axis=2)
            med = np.median(dist, axis=1)
            best = int(np.argmin(med))
        else:
            best = 0
        self.pt_desc[pt] = descs[best]
        self.pt_bits[pt] = np.unpackbits(descs[best], bitorder="little")
        cam_centers = -np.einsum(
            "nij,nj->ni", self.kf_pose[kfs, :3, :3].transpose(0, 2, 1),
            self.kf_pose[kfs, :3, 3],
        )
        normals = cam_centers - self.pt_pos[pt]
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(norms, 1e-9)
        n = normals.mean(axis=0)
        self.pt_normal[pt] = n / max(np.linalg.norm(n), 1e-9)
        # reference depth/level from the reference keyframe
        ref = self.pt_ref_kf[pt]
        if ref >= 0 and self.kf_valid[ref]:
            sel = kfs == ref
            if sel.any():
                T = self.kf_pose[ref]
                d = float(np.linalg.norm(
                    self.pt_pos[pt] + T[:3, :3].T @ T[:3, 3]
                ))
                self.pt_ref_depth[pt] = d
                self.pt_ref_level[pt] = self.kf_feat_octave[
                    ref, feats[sel][0]
                ]

    def replace_point(self, old: int, new: int):
        """MapPoint::Replace (reference: MapPoint.cpp:208-248): move all of
        old's observations onto new, then erase old."""
        if old == new:
            return
        kfs, feats = self.point_observations(old)
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        for k, f in zip(kfs, feats):
            self.kf_obs[k, f] = -1  # unlink before relink
            sel = (self.pt_obs_kf[old] == k) & (self.pt_obs_feat[old] == f)
            self.pt_obs_kf[old, sel] = -1
            self.pt_obs_feat[old, sel] = -1
            if self.kf_obs[k, f] < 0 and not (
                (self.pt_obs_kf[new] == k).any()
            ):
                self.add_observation(int(k), int(f), new)
        self.pt_n_obs[old] = 0
        self.erase_point(old)

    # ------------------------------------------------------------------
    # global transforms / stats
    # ------------------------------------------------------------------

    def transform(self, s: float, R: np.ndarray, t: np.ndarray):
        """Apply a Sim3 to the whole map (reference: Map::Transform,
        Snake/Map/Map.cpp:66-87).  x' = s R x + t; poses T' = T S^-1."""
        self.n_transforms = getattr(self, "n_transforms", 0) + 1
        ks = self.valid_keyframes()
        ps = self.valid_points()
        self.pt_pos[ps] = s * (self.pt_pos[ps] @ R.T) + t
        Sinv = np.eye(4)
        Sinv[:3, :3] = R.T / s
        Sinv[:3, 3] = -R.T @ t / s
        for k in ks:
            T = self.kf_pose[k] @ Sinv
            # renormalize rotation block (remove the 1/s scale)
            Rk = T[:3, :3]
            sk = np.cbrt(np.linalg.det(Rk))
            T[:3, :3] = Rk / sk
            T[:3, 3] = T[:3, 3] / sk
            self.kf_pose[k] = T
        self.kf_velocity[ks] *= s
        # culled-KF anchor rels: rotation invariant, translation scales
        # (same similarity algebra as FrameData.rel_to_ref)
        if s != 1.0 and self.erased_kf_rel:
            for key, (a, afid, rel) in list(self.erased_kf_rel.items()):
                rel = rel.copy()
                rel[:3, 3] *= s
                self.erased_kf_rel[key] = (a, afid, rel)
        self.state += 1
        for cb in self.on_transform:
            cb(s, R, t)

    def reprojection_stats(self, fx, fy, cx, cy):
        """Global reprojection RMSE over all observations
        (reference: Map::ReprojectionStats, Map.cpp:401-431)."""
        errs = []
        for pt in self.valid_points():
            kfs, feats = self.point_observations(pt)
            if len(kfs) == 0:
                continue
            T = self.kf_pose[kfs]
            pc = np.einsum("nij,j->ni", T[:, :3, :3], self.pt_pos[pt]) + T[:, :3, 3]
            z = np.maximum(pc[:, 2], 1e-6)
            u = fx * pc[:, 0] / z + cx
            v = fy * pc[:, 1] / z + cy
            uv = self.kf_feat_uv[kfs, feats]
            errs.append(((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2))
        if not errs:
            return 0.0
        return float(np.sqrt(np.concatenate(errs).mean()))

    def device_mirror(self, device):
        """Shared device-resident point mirror (lazily created): all
        consumers (tracker, fusion, triangulation, GBA) reuse one synced
        copy so point payload uploads happen once per map generation."""
        m = getattr(self, "_device_mirror", None)
        if m is None:
            from snakeslam_tpu_torch.map.device_mirror import DeviceMapMirror
            m = self._device_mirror = DeviceMapMirror(self, device)
        return m

    def kf_feature_pool(self, n_slots: int):
        """Shared device-resident keyframe feature pool (map/kf_pool.py)."""
        raise NotImplementedError(
            "kf_feature_pool: the keyframe feature pool is ported with the "
            "deferred keyframe cycle (ROADMAP.md queue A, step 8)")

    def validate(self) -> list[str]:
        """Full map consistency check (Map::valid analog, reference:
        Snake/Map/Map.cpp:504+, behind CHECK_VALID_MAP).  Returns a list of
        violation descriptions (empty = consistent)."""
        errors = []
        # forward/reverse observation tables must agree exactly
        for kf in self.valid_keyframes():
            n = self.kf_n_feat[kf]
            for f in np.nonzero(self.kf_obs[kf, :n] >= 0)[0]:
                pt = self.kf_obs[kf, f]
                if not self.pt_valid[pt]:
                    errors.append(f"kf {kf} feat {f} -> dead point {pt}")
                    continue
                sel = (self.pt_obs_kf[pt] == kf) & (self.pt_obs_feat[pt] == f)
                if not sel.any():
                    errors.append(
                        f"kf {kf} feat {f} -> point {pt} missing reverse obs"
                    )
        for pt in self.valid_points():
            kfs, feats = self.point_observations(int(pt))
            if len(kfs) != self.pt_n_obs[pt]:
                errors.append(f"point {pt} n_obs mismatch")
            seen_kfs = set()
            for k, f in zip(kfs, feats):
                if not self.kf_valid[k]:
                    errors.append(f"point {pt} observed by dead kf {k}")
                    continue
                if k in seen_kfs:
                    errors.append(f"point {pt} observed twice in kf {k}")
                seen_kfs.add(int(k))
                if self.kf_obs[k, f] != pt:
                    errors.append(
                        f"point {pt} reverse obs (kf {k}, feat {f}) "
                        f"disagrees with forward table"
                    )
        # temporal chain sanity
        for kf in self.valid_keyframes():
            nxt = self.kf_next[kf]
            if nxt >= 0 and self.kf_valid[nxt] and self.kf_prev[nxt] != kf:
                errors.append(f"chain broken at kf {kf} -> {nxt}")
        return errors

    def clear(self):
        listeners = self.on_transform
        self.__init__(self.max_keyframes, self.max_points, self.max_features)
        self.on_transform = listeners


def transform_pose_cw(T: np.ndarray, s: float, R: np.ndarray,
                      t: np.ndarray) -> np.ndarray:
    """Rebase a world->camera pose under the world Sim3 x' = s R x + t:
    R_cw' = R_cw R^T,  t_cw' = s t_cw - R_cw R^T t."""
    out = T.copy()
    Rn = T[:3, :3] @ R.T
    out[:3, :3] = Rn
    out[:3, 3] = s * T[:3, 3] - Rn @ t
    return out
