"""Local mapping: keyframe insertion and the per-keyframe back-end cycle.

Counterpart of ``snakeslam_tpu/mapping/local_mapping.py`` (the reference's
LocalMapping::Process fan-out hub): the synchronous half (observation
association with duplicate arbitration, stereo/depth point insertion,
spanning-tree update, median depth, IMU edge binding) and the deferred cycle — recent-point
culling, triangulation against the ``TRI_NB`` best covisible keyframes,
bidirectional neighbour fusion and the local BA dispatched back-to-back
against one snapshot (``dispatch_deferred``), then one readback and the
host commits (``commit_deferred``), then the back-end queues
(simplification, deferred mapper).  The runner software-pipelines cycles:
cycle k+1 is dispatched before cycle k commits.

On the card the triangulation of a cycle is one compiled program
(``triangulate_pool``, ``utils/graphs.py``), as the JAX package's
``_triangulate_pool``: the keyframe-pool gather, the pair search and the
triangulation in one captured CUDA graph.  The pool is passed by
reference (its address joins the key: nothing is copied into the graph);
the slots, free masks, poses, depth grid and ``th_depth`` are tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.map.kf_pool import pool_features
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.mapping.fusion import MapSearcher
from snakeslam_tpu_torch.ops.depth_grid import keyframe_depth_grid
from snakeslam_tpu_torch.ops.descriptors import hamming_np
from snakeslam_tpu_torch.ops.triangulate_pairs import triangulate_pairs_batch
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.tracking.staging import HostCopy, upload
from snakeslam_tpu_torch.utils import graphs

TRI_NB = 10  # fixed neighbour fan-out width (LocalMapping.cpp:317-329):
             # one shape regardless of covisible count


def _triangulate_pool(pool, slots, free_a, free_b, T_a, T_b, cam, bf,
                      scales, inv_sigma2, grid_a, th_depth,
                      feature_distance: int, epipolar_distance: float,
                      error_mono: float, bounds_wh: tuple):
    """The keyframe pool's rows ``slots[0]`` (keyframe a) and
    ``slots[1:]`` (its neighbours) gathered and triangulated pairwise
    (``triangulate_pairs_batch``).  ``th_depth`` is a 0-d tensor; the
    matcher's gates and the image bounds are static."""
    feats = pool_features(pool, slots)
    # row 0 by slicing: a 0-d index tensor would be read on the host
    return triangulate_pairs_batch(
        type(feats)(*(f[0] for f in feats)),
        type(feats)(*(f[1:] for f in feats)),
        free_a, free_b, T_a, T_b, cam, bf, scales, inv_sigma2,
        feature_distance=feature_distance,
        epipolar_distance=epipolar_distance, error_mono=error_mono,
        grid_a=grid_a, bounds_wh=bounds_wh, th_depth=th_depth)


# clone: the pipelined cycle commits a keyframe cycle after its dispatch
triangulate_pool = graphs.compiled(
    _triangulate_pool,
    static=("feature_distance", "epipolar_distance", "error_mono",
            "bounds_wh"),
    by_ref=("pool",), clone=True, name="triangulate_pool")


class LocalMapper:
    def __init__(self, settings: Settings, smap: SlamMap, device, lba=None,
                 backends=None, imu_solver=None):
        self.s = settings
        self.map = smap
        self.device = torch.device(device)
        self.lba = lba
        self.imu_solver = imu_solver
        self.backends = backends or []  # further queues (simplification, ...)
        self.map_searcher = MapSearcher(settings, smap, self.device)
        self.recent_points: list[tuple[int, int]] = []  # (pt, created_at_kf)
        dev = self.device
        pyr = ScalePyramid.create(settings.fd_levels,
                                  settings.fd_scale_factor)
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=dev)
        self.bf = torch.tensor(settings.bf, dtype=torch.float32, device=dev)
        self.scales = torch.as_tensor(pyr.scales, device=dev)
        self.inv_sigma2 = torch.as_tensor(pyr.inv_sigma2, device=dev)
        self._last_kf_frame_id = -10
        self._deferred: list[tuple[int, FrameData]] = []
        self.n_triangulated = 0   # points created by _tri_commit

    def on_map_initialized(self, kf: int):
        self._last_kf_frame_id = self.map.kf_frame_id[kf]

    # ------------------------------------------------------------------
    # keyframe insertion gates (KeyframeInserter.cpp:27-66)
    # ------------------------------------------------------------------

    def insert_keyframe(self, frame: FrameData, prev_kf: int,
                        defer: bool = False) -> int:
        """Allocate the keyframe and run the synchronous half; the deferred
        cycle runs now, or (defer=True) at flush_deferred() / when the
        windowed runner dispatches it, overlapping the tracking windows."""
        with tracer.span("kf.insert"):
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
        cycle k+1 is dispatched before cycle k commits, so k+1 works on a
        one-cycle-stale snapshot (the reference's async back-end staleness;
        the commits' per-element guards were built for it)."""
        n = 0
        prev = None
        while self._deferred:
            kf, frame = self._deferred.pop(0)
            if not self.map.kf_valid[kf]:
                n += 1
                continue
            tok = self.dispatch_deferred(kf)
            if prev is not None:
                self.commit_deferred_checked(prev)
            prev = tok
            n += 1
        if prev is not None:
            self.commit_deferred_checked(prev)
        return n

    def commit_deferred_checked(self, tok: dict):
        """Commit a pipelined cycle, re-running it from scratch if a
        whole-map rebase landed after its dispatch (its device results are
        in the old basis)."""
        if getattr(self.map, "n_transforms", 0) != tok["n_transforms"]:
            kf = tok["kf"]
            if self.map.kf_valid[kf]:
                self.process_deferred(kf, None)
            return
        self.commit_deferred(tok)

    # ------------------------------------------------------------------
    # the fan-out hub (LocalMapping.cpp:37-117)
    # ------------------------------------------------------------------

    def process_sync(self, kf: int, frame: FrameData):
        self._associate_observations(kf, frame)
        if self.s.input_type != InputType.Mono:
            self._insert_stereo_points(kf, frame)
        self.map.update_spanning_tree_parent(kf)
        self.map.compute_median_depth(kf)
        # IMU edge binding consumes the pending sample window and must run
        # at insertion order (before later frames feed more samples)
        if self.imu_solver is not None:
            self.imu_solver.process_new_keyframe(kf, int(self.map.kf_prev[kf]))

    def process_deferred(self, kf: int, frame: FrameData):
        self.commit_deferred(self.dispatch_deferred(kf))

    def dispatch_deferred(self, kf: int) -> dict:
        """Dispatch half of the per-keyframe cycle: triangulation,
        bidirectional neighbour fusion and the local BA queued back-to-back
        against the same pre-commit snapshot, their results copied to
        pinned host memory behind one CUDA event.  Returns the token for
        commit_deferred; tracking may go on while the device works."""
        with tracer.span("kf_cycle.dispatch", self.map.kf_frame_id[kf]):
            self._cull_recent_points(kf)
            tri = self._tri_dispatch(kf)
            fuse = (self.map_searcher.dispatch(kf)
                    if self.map_searcher is not None else None)
            ba = None
            if self.lba is not None:
                if hasattr(self.lba, "dispatch"):
                    ba = self.lba.dispatch(kf)
                else:
                    # async_lba: the worker runs whole LBA cycles itself
                    # (AsyncLBA, system/pipeline.py)
                    self.lba.add(kf)
            arrays = []
            if tri is not None:
                arrays += [tri[0]["valid"], tri[0]["match_b"],
                           tri[0]["point"]]
            if fuse is not None:
                arrays += fuse[0]
            if ba is not None:
                arrays += ba[0]
            return dict(kf=kf, tri=tri, fuse=fuse, ba=ba,
                        copy=HostCopy(arrays),
                        n_transforms=getattr(self.map, "n_transforms", 0))

    def deferred_ready(self, token: dict) -> bool:
        """True when every result of a dispatched cycle has landed on the
        host (commit_deferred will not block)."""
        return token["copy"].ready()

    def commit_deferred(self, token: dict):
        """Blocking half: wait for the readback, then the host commits."""
        kf = token["kf"]
        if not self.map.kf_valid[kf]:
            return
        tri, fuse, ba = token["tri"], token["fuse"], token["ba"]
        frame_id = self.map.kf_frame_id[kf]
        with tracer.span("kf_cycle.wait", frame_id):
            fetched = token["copy"].wait()
        with tracer.span("kf_cycle.commit", frame_id):
            if tri is not None:
                self._tri_commit(kf, fetched[0], fetched[1],
                                 fetched[2].astype(np.float64), tri[1])
                del fetched[:3]
            if fuse is not None:
                nf = len(fuse[0])
                self.map_searcher.commit(kf, fetched[:nf], fuse[1])
                del fetched[:nf]
            self.map.update_points_bulk(self.map.keyframe_points(kf),
                                        only_dirty=True)
            if ba is not None:
                self.lba.commit(kf, fetched, ba[1])
            if self.imu_solver is not None:
                # the visual-inertial state machine, after the local BA
                self.imu_solver.update_map()
        with tracer.span("kf_cycle.backends", frame_id):
            for b in self.backends:
                b.add(kf)

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

    # ------------------------------------------------------------------

    def _tri_dispatch(self, kf: int, num_neighbors: int = 10,
                      feature_distance: int = 50,
                      epipolar_distance: float = 4.0,
                      error_mono: float = 2.1):
        """Async half of triangulation: stage + queue, no blocking.  One
        batched call covers every neighbour pair, padded to TRI_NB rows
        (pad rows get free_b all False: no candidates)."""
        smap = self.map
        dev = self.device
        ids, w = smap.covisible_keyframes(kf, min_weight=15)
        neighbors = ids[:min(num_neighbors, TRI_NB)]
        if len(neighbors) == 0:
            return None
        n_slots = self.s.feature_slots
        free_a = np.zeros(n_slots, dtype=bool)
        na = int(smap.kf_n_feat[kf])
        free_a[:na] = smap.kf_obs[kf, :na] < 0

        padded = [int(n) for n in neighbors]
        padded += [padded[-1]] * (TRI_NB - len(neighbors))
        pool = smap.kf_feature_pool(n_slots, dev)
        slots = pool.slots_for([kf] + padded)
        free_b = np.zeros((TRI_NB, n_slots), dtype=bool)
        for i, nb in enumerate(neighbors):
            nbn = int(smap.kf_n_feat[nb])
            free_b[i, :nbn] = smap.kf_obs[nb, :nbn] < 0
        # depth-completion grid: a depth prior per free feature lets the
        # matcher retry epipolar-ambiguous matches in a projection window
        grid = keyframe_depth_grid(smap, kf, self.s.width, self.s.height)

        out = triangulate_pool(
            pool.arrays, upload(slots.astype(np.int64), dev),
            upload(free_a, dev), upload(free_b, dev),
            upload(smap.kf_pose[kf].astype(np.float32), dev),
            upload(smap.kf_pose[padded].astype(np.float32), dev),
            self.cam, self.bf, self.scales, self.inv_sigma2,
            upload(grid, dev),
            upload(np.asarray(self.s.th_depth, dtype=np.float32), dev),
            feature_distance=int(feature_distance),
            epipolar_distance=float(epipolar_distance),
            error_mono=float(error_mono),
            bounds_wh=(float(self.s.width), float(self.s.height)),
        )
        return out, dict(neighbors=neighbors, free_a=free_a)

    def _tri_commit(self, kf: int, valid_all, match_all, pts_all, ctx):
        """Host commit half of triangulation: earlier neighbours claim
        features first; freeness is re-checked at commit time, since the
        pipelined fuse / association passes may have linked some of these
        feature slots since dispatch."""
        smap = self.map
        if not smap.kf_valid[kf]:
            return 0  # culled since dispatch (pipelined flush)
        neighbors = ctx["neighbors"]
        free_a = ctx["free_a"]
        sel_i: list[np.ndarray] = []
        sel_j: list[np.ndarray] = []
        sel_nb: list[int] = []
        sel_wp: list[np.ndarray] = []
        free_now = free_a & (smap.kf_obs[kf, :len(free_a)] < 0)
        for bi, nb in enumerate(int(n) for n in neighbors):
            cand = np.nonzero(valid_all[bi] & free_now)[0]
            if len(cand) == 0:
                continue
            j = match_all[bi][cand]
            ok = smap.kf_obs[nb, j] < 0
            # a neighbour feature may win multiple rows; keep the first
            _, first = np.unique(j, return_index=True)
            keep = np.zeros(len(j), dtype=bool)
            keep[first] = True
            cand, j = cand[ok & keep], j[ok & keep]
            if len(cand) == 0:
                continue
            free_now[cand] = False
            sel_i.append(cand)
            sel_j.append(j)
            sel_nb.append(nb)
            sel_wp.append(pts_all[bi][cand])
        if not sel_i:
            return 0
        all_i = np.concatenate(sel_i)
        wps = np.concatenate(sel_wp)
        cam_pos = -smap.kf_pose[kf][:3, :3].T @ smap.kf_pose[kf][:3, 3]
        normals = cam_pos[None, :] - wps
        depths = np.linalg.norm(normals, axis=1)
        normals = normals / np.maximum(depths, 1e-9)[:, None]
        ids = smap.allocate_points_bulk(
            wps, smap.kf_feat_desc[kf, all_i], kf, depths,
            smap.kf_feat_octave[kf, all_i], normals,
        )
        smap.add_observations_bulk(kf, all_i, ids)
        off = 0
        for cand, j, nb in zip(sel_i, sel_j, sel_nb):
            smap.add_observations_bulk(nb, j, ids[off:off + len(cand)])
            off += len(cand)
        self.recent_points.extend((int(p), kf) for p in ids)
        self.n_triangulated += len(ids)
        return len(ids)
