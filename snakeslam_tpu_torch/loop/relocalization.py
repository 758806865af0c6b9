"""Relocalization: BoW candidate retrieval + PnP recovery after tracking loss.

Counterpart of ``snakeslam_tpu/loop/relocalization.py`` (the reference's
try_localize path: keyframe-database candidates, descriptor matching, PnP
RANSAC, robust pose refinement).  Host orchestration; the matching and the
PnP run on the system's device, the RANSAC drawing from a threefry key
seeded ``random_seed + 13`` and split once per candidate that reaches it,
as the JAX relocalizer draws (``core/prng.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.loop.keyframe_database import KeyframeDatabase
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.ops.descriptors import unpack_bits_np
from snakeslam_tpu_torch.ops.matching import knn2_ratio_match_np
from snakeslam_tpu_torch.ops.pose_solver import pnp_refine_np
from snakeslam_tpu_torch.system.settings import Settings

MIN_RELOC_INLIERS = 30


class Relocalizer:
    def __init__(self, settings: Settings, smap: SlamMap,
                 database: KeyframeDatabase, device):
        self.s = settings
        self.map = smap
        self.db = database
        self.device = torch.device(device)
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=self.device)
        self.bf = torch.tensor(settings.bf, dtype=torch.float32,
                               device=self.device)
        self.key = prng.PRNGKey(settings.random_seed + 13)

    def try_relocalize(self, frame: FrameData) -> bool:
        """On success fills frame.pose_cw + frame.matches and returns True."""
        smap = self.map
        frame_bits = unpack_bits_np(frame.descriptors)
        ids, _ = self.db.detect_relocalization_candidates(frame_bits, top_n=3)
        for cand in ids:
            cand = int(cand)
            if not smap.kf_valid[cand]:
                continue
            n = int(smap.kf_n_feat[cand])
            feats = np.nonzero(smap.kf_obs[cand, :n] >= 0)[0]
            pts = smap.kf_obs[cand, feats]
            pts = pts[smap.pt_valid[pts]]
            if len(pts) < MIN_RELOC_INLIERS:
                continue
            idx, _ = knn2_ratio_match_np(frame_bits, smap.pt_bits[pts],
                                         ratio=0.75, max_dist=50,
                                         device=self.device)
            sel = idx >= 0
            if sel.sum() < MIN_RELOC_INLIERS:
                continue
            obs_pts = smap.pt_pos[pts[idx[sel]]]
            self.key, sub = prng.split(self.key)
            n0, T, inlier, n_inl = pnp_refine_np(
                obs_pts, frame.uv[sel], self.cam, self.bf, sub,
                n_hypotheses=512)
            if n0 < MIN_RELOC_INLIERS // 2 or n_inl < MIN_RELOC_INLIERS:
                continue
            frame.pose_cw = T.cpu().numpy().astype(np.float64)
            matches = np.full(frame.n, -1, dtype=np.int64)
            sel_idx = np.nonzero(sel)[0]
            matches[sel_idx[inlier]] = pts[idx[sel]][inlier]
            frame.matches = matches
            frame.outlier = np.zeros(frame.n, dtype=bool)
            frame.ref_kf = cand
            frame.capture_rel(smap.kf_pose[cand], smap.kf_frame_id[cand])
            return True
        return False
