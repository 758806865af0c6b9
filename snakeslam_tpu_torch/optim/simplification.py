"""Keyframe-graph simplification: the MST-based keyframe culling.

Replacement for the reference's headline Simplification module (reference:
Snake/Optimizer/Simplification.{h,cpp}, the ICUAS'21 paper's keyframe-
reduction idea): per candidate keyframe —
  * force-cull when cull_factor > 3 (:148-157),
  * IMU guards: no cull when VI init is running or the temporal gap to the
    neighbors would exceed max_time_between_kf_map = 0.5 s (:158-179),
  * build the local covisibility graph (edges >= 20 shared points) around
    the candidate, compute its MST (:250-341),
  * leaf keyframes (1 MST edge) are culled on small view angle / low match
    count / ORB-SLAM-style redundancy > 0.8 (:287-310),
  * interior keyframes are culled when the MST recomputed without the
    candidate has its weakest link above th_map (:313-357),
  * erase re-enqueues 3 neighbors (:50-64).

Graphs here are <= ~30 nodes, so the MST runs host-side (SURVEY.md notes
this is deliberately not a device workload).
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.map.slam_map import SlamMap
from snakeslam_tpu_torch.system.settings import Settings

MIN_EDGE_WEIGHT = 20
REDUNDANCY_RATIO = 0.8
MAX_TIME_GAP = 0.5      # max_time_between_kf_map (SnakeGlobal.h:199)


def _mst(nodes: list[int], weights: dict[tuple[int, int], int]):
    """Maximum spanning tree (Prim) over weighted covisibility.

    Returns (edges [(i, j, w)], min_edge_weight) or (None, 0) if the graph
    is disconnected."""
    if len(nodes) <= 1:
        return [], 0
    in_tree = {nodes[0]}
    edges = []
    min_w = np.inf
    while len(in_tree) < len(nodes):
        best = None
        for (a, b), w in weights.items():
            if (a in in_tree) != (b in in_tree):
                if best is None or w > best[2]:
                    best = (a, b, w)
        if best is None:
            return None, 0
        in_tree.add(best[0] if best[1] in in_tree else best[1])
        edges.append(best)
        min_w = min(min_w, best[2])
    return edges, int(min_w)


class Simplification:
    def __init__(self, settings: Settings, smap: SlamMap,
                 imu_solver=None):
        self.s = settings
        self.map = smap
        self.imu_solver = imu_solver
        self.n_culled = 0
        self._requeue: list[int] = []

    def add(self, kf: int):
        self.process(kf)
        # culled keyframes re-enqueue their neighbors (:50-64)
        requeue, self._requeue = self._requeue, []
        for k in requeue:
            if self.map.kf_valid[k]:
                self.process(k)

    # ------------------------------------------------------------------

    def process(self, kf: int) -> bool:
        smap = self.map
        if not smap.kf_valid[kf]:
            return False
        if smap.kf_next[kf] < 0 or smap.kf_prev[kf] < 0:
            return False  # keep the chain endpoints

        force = smap.kf_cull_factor[kf] > 3.0
        if not force and not self._guards_pass(kf):
            return False
        if force or self._cull_test(kf):
            self._erase(kf)
            return True
        return False

    def _guards_pass(self, kf: int) -> bool:
        smap = self.map
        if self.imu_solver is not None and self.s.enable_imu:
            if not self.imu_solver.gravity_initialized:
                return False  # never cull during VI initialization
            prev, nxt = smap.kf_prev[kf], smap.kf_next[kf]
            gap = smap.kf_timestamp[nxt] - smap.kf_timestamp[prev]
            if gap > MAX_TIME_GAP * 2.01:
                return False  # culling would break the IMU chain cadence
        return True

    # ------------------------------------------------------------------

    def _cull_test(self, kf: int) -> bool:
        smap = self.map
        cull_bias = float(smap.kf_cull_factor[kf])
        ids, w = smap.covisible_keyframes(kf, min_weight=MIN_EDGE_WEIGHT)
        if len(ids) == 0:
            return False
        nodes = [kf] + [int(i) for i in ids[:20]]
        node_set = set(nodes)
        weights = {}
        for a in nodes:
            ca, cw = smap.covisible_keyframes(a, min_weight=MIN_EDGE_WEIGHT)
            for b, wt in zip(ca, cw):
                b = int(b)
                if b in node_set and b > a:
                    weights[(a, b)] = int(wt)
        edges, _ = _mst(nodes, weights)
        if edges is None:
            return False
        degree = {}
        for a, b, _ in edges:
            degree[a] = degree.get(a, 0) + 1
            degree[b] = degree.get(b, 0) + 1

        if degree.get(kf, 0) <= 1:
            # leaf: redundancy test (:287-310)
            return self._redundancy(kf) > REDUNDANCY_RATIO / cull_bias
        # interior: remove kf, re-span; weakest link must stay strong
        nodes2 = [n for n in nodes if n != kf]
        weights2 = {e: v for e, v in weights.items() if kf not in e}
        edges2, min_w = _mst(nodes2, weights2)
        if edges2 is None:
            return False
        return min_w > self.s.th_map / cull_bias

    def _redundancy(self, kf: int) -> float:
        """Fraction of the KF's points observed by >= 3 other keyframes at
        the same or finer scale (ORB-SLAM keyframe-culling criterion)."""
        smap = self.map
        n = int(smap.kf_n_feat[kf])
        feats = np.nonzero(smap.kf_obs[kf, :n] >= 0)[0]
        if len(feats) == 0:
            return 1.0
        pts = smap.kf_obs[kf, feats]
        redundant = 0
        for f, pt in zip(feats, pts):
            my_oct = smap.kf_feat_octave[kf, f]
            kfs_o, feats_o = smap.point_observations(int(pt))
            n_better = 0
            for ko, fo in zip(kfs_o, feats_o):
                if ko == kf:
                    continue
                if smap.kf_feat_octave[ko, fo] <= my_oct + 1:
                    n_better += 1
            if n_better >= 3:
                redundant += 1
        return redundant / len(feats)

    def _erase(self, kf: int):
        smap = self.map
        ids, _ = smap.covisible_keyframes(kf, min_weight=MIN_EDGE_WEIGHT)
        self._requeue.extend(int(i) for i in ids[:3])
        smap.erase_keyframe(kf)
        self.n_culled += 1
