"""Local mapping: keyframe insertion and map maintenance.

Counterpart of ``snakeslam_tpu/mapping/local_mapping.py`` up to the
keyframe's synchronous half: observation association with duplicate
arbitration, stereo/depth point insertion, spanning-tree update and median
depth (``process_sync``), plus the deferred-cycle skeleton
(``dispatch_deferred`` / ``commit_deferred`` / ``flush_deferred``) with the
recent-point culling and the dirty-point refresh it runs.  Triangulation,
neighbour fusion and local BA — the device work of the deferred cycle —
arrive with ROADMAP.md queue A step 8; the loop, simplification and
deferred-mapper back-ends with step 9.  Until then this is the JAX
package's own configuration with ``lba=None``, no map searcher, no
back-ends and no triangulation dispatch.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.ops.descriptors import hamming_np
from snakeslam_tpu_torch.system.settings import InputType, Settings


class LocalMapper:
    def __init__(self, settings: Settings, smap: SlamMap):
        self.s = settings
        self.map = smap
        self.recent_points: list[tuple[int, int]] = []  # (pt, created_at_kf)
        self._last_kf_frame_id = -10
        self._deferred: list[tuple[int, FrameData]] = []

    def on_map_initialized(self, kf: int):
        self._last_kf_frame_id = self.map.kf_frame_id[kf]

    # ------------------------------------------------------------------
    # keyframe insertion gates (KeyframeInserter.cpp:27-66)
    # ------------------------------------------------------------------

    def insert_keyframe(self, frame: FrameData, prev_kf: int,
                        defer: bool = False) -> int:
        """Allocate the keyframe and run the synchronous half; the deferred
        cycle runs now, or (defer=True) at flush_deferred()."""
        if frame.frame_id - self._last_kf_frame_id < 1:
            return -1
        n_inl = int((frame.matches >= 0).sum())
        if n_inl < 30:
            return -1
        kf = self.map.allocate_keyframe(frame)
        self.map.kf_prev[kf] = prev_kf
        if prev_kf >= 0:
            self.map.kf_next[prev_kf] = kf
        frame.is_keyframe = True
        frame.ref_kf = kf
        frame.rel_to_ref = np.eye(4)  # the frame IS the keyframe
        frame.ref_frame_id = int(frame.frame_id)
        self._last_kf_frame_id = frame.frame_id
        self.process_sync(kf, frame)
        if defer:
            self._deferred.append((kf, frame))
        else:
            self.process_deferred(kf, frame)
        return kf

    def flush_deferred(self) -> int:
        """Run the queued deferred cycles in insertion order, pipelined:
        cycle k+1 is dispatched before cycle k commits."""
        n = 0
        prev = None
        while self._deferred:
            kf, frame = self._deferred.pop(0)
            if not self.map.kf_valid[kf]:
                n += 1
                continue
            tok = self.dispatch_deferred(kf)
            if prev is not None:
                self.commit_deferred(prev)
            prev = tok
            n += 1
        if prev is not None:
            self.commit_deferred(prev)
        return n

    # ------------------------------------------------------------------
    # the fan-out hub (LocalMapping.cpp:37-117)
    # ------------------------------------------------------------------

    def process_sync(self, kf: int, frame: FrameData):
        self._associate_observations(kf, frame)
        if self.s.input_type != InputType.Mono:
            self._insert_stereo_points(kf, frame)
        self.map.update_spanning_tree_parent(kf)
        self.map.compute_median_depth(kf)

    def process_deferred(self, kf: int, frame: FrameData):
        self.commit_deferred(self.dispatch_deferred(kf))

    def dispatch_deferred(self, kf: int) -> dict:
        """Dispatch half of the per-keyframe cycle.  With triangulation,
        fusion and LBA not yet ported it culls the recent points and has
        no device work to queue."""
        self._cull_recent_points(kf)
        return dict(kf=kf)

    def commit_deferred(self, token: dict):
        """Commit half: refresh descriptors / normals of the keyframe's
        points whose observations changed."""
        kf = token["kf"]
        if not self.map.kf_valid[kf]:
            return
        self.map.update_points_bulk(self.map.keyframe_points(kf),
                                    only_dirty=True)

    # ------------------------------------------------------------------

    def _associate_observations(self, kf: int, frame: FrameData):
        """ProcessNewKeyFrame association + descriptor-distance dedup:
        dead-point drop, duplicate arbitration (two features matched to one
        point keep the closer descriptor), one bulk observation insert."""
        smap = self.map
        idx = np.nonzero(frame.matches >= 0)[0]
        if len(idx) == 0:
            return
        pts = frame.matches[idx].astype(np.int64)
        dead = ~smap.pt_valid[pts]
        if dead.any():
            frame.matches[idx[dead]] = -1
            idx, pts = idx[~dead], pts[~dead]
            if len(idx) == 0:
                return
        uniq, counts = np.unique(pts, return_counts=True)
        if (counts > 1).any():
            keep = np.ones(len(idx), dtype=bool)
            for p in uniq[counts > 1]:
                cand = np.nonzero(pts == p)[0]
                d = hamming_np(smap.pt_desc[p][None],
                               frame.descriptors[idx[cand]])[0]
                lose = cand[cand != cand[int(d.argmin())]]
                keep[lose] = False
                frame.matches[idx[lose]] = -1
            idx, pts = idx[keep], pts[keep]
        ok = smap.add_observations_bulk(kf, idx, pts)
        if not ok.all():
            frame.matches[idx[~ok]] = -1  # observation slot overflow

    def _insert_stereo_points(self, kf: int, frame: FrameData):
        """Create map points for unmatched depth features."""
        smap = self.map
        T = smap.kf_pose[kf]
        Rinv = T[:3, :3].T
        cam_pos = -Rinv @ T[:3, 3]
        fx, fy, cx, cy = self.s.fx, self.s.fy, self.s.cx, self.s.cy
        sel = np.nonzero((frame.depth > 0) & (frame.matches < 0))[0]
        if len(sel) == 0:
            return
        z = frame.depth[sel]
        pc = np.stack([
            (frame.uv[sel, 0] - cx) / fx * z,
            (frame.uv[sel, 1] - cy) / fy * z,
            z,
        ], axis=1)
        wp = pc @ Rinv.T + cam_pos
        normals = cam_pos - wp
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                              1e-9)
        pts = smap.allocate_points_bulk(
            wp, frame.descriptors[sel], kf, np.linalg.norm(pc, axis=1),
            frame.octave[sel], normals,
        )
        smap.add_observations_bulk(kf, sel, pts)
        frame.matches[sel] = pts
        self.recent_points.extend((int(p), kf) for p in pts)

    def _cull_recent_points(self, kf: int):
        """Found-ratio / observation-count culling (LocalMapping.cpp:267-313)."""
        smap = self.map
        min_matches = 2 if self.s.input_type == InputType.Mono else 3
        kept = []
        kf_seq = {int(k): n for n, k in enumerate(smap.valid_keyframes())}
        cur = kf_seq.get(kf, len(kf_seq))
        for pt, created_kf in self.recent_points:
            if not smap.pt_valid[pt]:
                continue
            age = cur - kf_seq.get(created_kf, 0)
            found_ratio = smap.pt_found[pt] / max(smap.pt_visible[pt], 1)
            if found_ratio < 0.25:
                smap.erase_point(pt)
            elif age >= 2 and smap.pt_n_obs[pt] <= min_matches:
                smap.erase_point(pt)
            elif age >= 3:
                pass  # graduated
            else:
                kept.append((pt, created_kf))
        self.recent_points = kept
