"""Chaos / fault-injection hooks for robustness testing.

Replacement for the reference's built-in fault injection (reference:
Snake/Map/Map.h:153-156, Map.cpp:90-140 — crazyMove, RemoveRandomPoint/
Keyframe/Observation; imgui button System.cpp:393-396).  These exercise the
recovery paths: RECOVERING state, relocalization, map clear.

Counterpart of ``snakeslam_tpu/map/chaos.py``: the same numpy generator
draws in the same order, so one seed removes the same map elements in both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.map.slam_map import SlamMap


class Chaos:
    def __init__(self, smap: SlamMap, seed: int = 0):
        self.map = smap
        self.rng = np.random.default_rng(seed)

    def crazy_move(self, magnitude: float = 0.5):
        """Random SE3 of the whole map (Map::crazyMove)."""
        w = self.rng.normal(scale=magnitude * 0.2, size=3)
        t = self.rng.normal(scale=magnitude, size=3)
        R = lie.so3_exp(torch.from_numpy(w)).numpy()
        self.map.transform(1.0, R, t)

    def remove_random_point(self, n: int = 1):
        pts = self.map.valid_points()
        if len(pts) == 0:
            return
        for p in self.rng.choice(pts, size=min(n, len(pts)), replace=False):
            self.map.erase_point(int(p))

    def remove_random_keyframe(self):
        ks = self.map.valid_keyframes()
        # never the endpoints (the chain splice needs both neighbors)
        interior = [k for k in ks
                    if self.map.kf_prev[k] >= 0 and self.map.kf_next[k] >= 0]
        if not interior:
            return
        self.map.erase_keyframe(int(self.rng.choice(interior)))

    def remove_random_observation(self, n: int = 1):
        ks = self.map.valid_keyframes()
        if len(ks) == 0:
            return
        for _ in range(n):
            k = int(self.rng.choice(ks))
            nf = self.map.kf_n_feat[k]
            feats = np.nonzero(self.map.kf_obs[k, :nf] >= 0)[0]
            if len(feats):
                self.map.remove_observation(k, int(self.rng.choice(feats)))
