"""Neighbour fusion: merge duplicate map points across covisible keyframes.

Counterpart of ``snakeslam_tpu/mapping/fusion.py`` (the reference's
MapSearcher / NeighbourSearch and the MappingORBMatcher Fuse overloads):
bidirectional projection of map points into covisible keyframes' feature
sets; a hit on a feature that already has a point merges the two (the
better-observed one stays), a hit on a free feature adds an observation.
The projection search is ``ops/matching.search_by_projection_fine``: the
forward pass runs it once over all ``FUSE_NB`` neighbour rows of the
keyframe feature pool (a leading batch dim), the backward pass once against
the new keyframe, so one fuse cycle is two batched searches.  The commit is
host-side map surgery.

On the card each search is a compiled program (``utils/graphs.py``), as
the JAX package jits them: ``fuse_pool`` gathers its keyframe-pool rows
inside the graph, the pool passed by reference (the forward pass's
``FUSE_NB`` rows, and the backward pass's one row as a batch of one, each
shape its own graph); ``fuse_search_single`` searches one keyframe's
cached features (loop closing's SearchAndFuse, ``th = 4``).  The
pyramid's level count, the image bounds and ``th`` are static.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.map.kf_pool import pool_features
from snakeslam_tpu_torch.map.slam_map import SlamMap
from snakeslam_tpu_torch.ops import matching as M
from snakeslam_tpu_torch.system.settings import Settings
from snakeslam_tpu_torch.tracking.staging import (HostCopy,
                                                  kf_features_cached, upload)
from snakeslam_tpu_torch.utils import graphs

FUSE_NB = 16  # fixed forward fan-out width (n_neighbors=15 + pad): one
              # shape regardless of covisible count


def _fuse_search(lm, feats, pose, cam, bf, scales, log_sf, levels: int,
                 bounds: tuple, th: float = 1.0):
    """Projection search of ``lm`` into ``feats`` at ``pose`` (leading
    batch dims allowed) -> feat_point.  ``th`` scales the window: 1.0 for
    neighbour fusion, 4.0 for the post-loop SearchAndFuse."""
    st = M.ScaleTables(scales=scales, log_scale_factor=log_sf, levels=levels)
    return M.search_by_projection_fine(
        lm, feats, pose, cam, bf, bounds, st, feat_free=feats.valid, th=th,
        ratio=0.9)["feat_point"]


def _fuse_pool(pool, slots, lm, pose, cam, bf, scales, log_sf, levels: int,
               bounds: tuple):
    """``_fuse_search`` (th 1) into the keyframe-pool rows ``slots`` (B,)
    at the (B, 4, 4) ``pose`` -> (B, slots) feat_point."""
    return _fuse_search(lm, pool_features(pool, slots), pose, cam, bf,
                        scales, log_sf, levels, bounds)


_FUSE_STATIC = ("levels", "bounds")
# clone: the pipelined cycle commits a keyframe cycle after its dispatch
fuse_pool = graphs.compiled(_fuse_pool, static=_FUSE_STATIC,
                            by_ref=("pool",), clone=True, name="fuse_pool")
fuse_search_single = graphs.compiled(_fuse_search,
                                     static=_FUSE_STATIC + ("th",),
                                     name="fuse_search_single")


class MapSearcher:
    def __init__(self, settings: Settings, smap: SlamMap, device):
        self.s = settings
        self.map = smap
        self.device = torch.device(device)
        dev = self.device
        self.cam = Pinhole.create(settings.fx, settings.fy, settings.cx,
                                  settings.cy, device=dev)
        self.bf = torch.tensor(settings.bf, dtype=torch.float32, device=dev)
        self.st = M.ScaleTables.from_pyramid(
            ScalePyramid.create(settings.fd_levels, settings.fd_scale_factor),
            device=dev)
        self.bounds = (0.0, 0.0, float(settings.width),
                       float(settings.height))
        self.n_fused = 0   # merges + links made by commit()

    def _tables(self) -> dict:
        """The searches' camera, scale tables and static settings."""
        st = self.st
        return dict(cam=self.cam, bf=self.bf, scales=st.scales,
                    log_sf=st.log_scale_factor, levels=st.levels,
                    bounds=self.bounds)

    # ------------------------------------------------------------------

    def _fuse_points_into_kf(self, point_ids: np.ndarray, kf: int,
                             staged=None, th: float = 1.0) -> int:
        """Project ``point_ids`` into keyframe ``kf`` and merge/link hits."""
        smap = self.map
        if len(point_ids) == 0:
            return 0
        if staged is None:
            staged = smap.device_mirror(self.device).gather(
                point_ids, self.s.local_map_slots)
        lm, ids = staged
        feats = kf_features_cached(smap, kf, self.s.feature_slots,
                                   self.device)
        pose = upload(smap.kf_pose[kf].astype(np.float32), self.device)
        fp = HostCopy([fuse_search_single(lm, feats, pose, th=float(th),
                                          **self._tables())]).wait()[0]
        return self._commit_fuse(fp, ids, kf)

    def _commit_fuse(self, feat_point: np.ndarray, ids: np.ndarray,
                     kf: int, gen: np.ndarray | None = None) -> int:
        smap = self.map
        if not smap.kf_valid[kf]:
            return 0
        n = int(smap.kf_n_feat[kf])
        fused = 0
        for f in np.nonzero(feat_point[:n] >= 0)[0]:
            slot = feat_point[f]
            p = int(ids[slot])
            if not smap.pt_valid[p]:
                continue
            if gen is not None and smap.pt_alloc_gen[p] != gen[slot]:
                continue  # slot recycled since dispatch
            existing = smap.kf_obs[kf, f]
            if existing == p:
                continue
            if existing >= 0:
                # duplicate: keep the better-observed point
                if smap.pt_n_obs[existing] >= smap.pt_n_obs[p]:
                    smap.replace_point(p, int(existing))
                else:
                    smap.replace_point(int(existing), p)
                fused += 1
            else:
                if (smap.pt_obs_kf[p] == kf).any():
                    continue  # already observed elsewhere in this KF
                smap.add_observation(kf, int(f), p)
                fused += 1
        return fused

    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Point-snapshot width: pinned to local_map_slots under
        pin_local_map_bucket, else a power of two from 1024."""
        if getattr(self.s, "pin_local_map_bucket", False):
            return self.s.local_map_slots
        b = 1024
        while b < n:
            b *= 2
        return min(b, self.s.local_map_slots)

    def dispatch(self, kf: int, n_neighbors: int = 15):
        """Async half: stage and queue both fuse directions, no blocking.
        Returns ([device tensors], ctx) or None."""
        smap = self.map
        dev = self.device
        ids, w = smap.covisible_keyframes(kf, min_weight=1)
        neighbors = [int(k) for k in ids[:min(n_neighbors, FUSE_NB)]]
        if not neighbors:
            return None
        mirror = smap.device_mirror(dev)
        pool = smap.kf_feature_pool(self.s.feature_slots, dev)
        kf_pts = smap.keyframe_points(kf)
        # forward: this KF's points into all neighbours in one batched
        # search, padded to FUSE_NB rows (pad-row results are never
        # committed)
        padded = neighbors + [neighbors[-1]] * (FUSE_NB - len(neighbors))
        nb_slots = pool.slots_for(padded)
        kf_slot = int(pool.slots_for([kf])[0])
        fp_fwd = ids_f = None
        if len(kf_pts):
            lm_f, ids_f = mirror.gather(kf_pts, self._bucket(len(kf_pts)))
            fp_fwd = fuse_pool(
                pool.arrays, upload(nb_slots.astype(np.int64), dev), lm_f,
                upload(smap.kf_pose[padded].astype(np.float32), dev),
                **self._tables())
        # backward: all neighbour points into this KF (same snapshot)
        nb_pts = np.unique(np.concatenate(
            [smap.keyframe_points(nb) for nb in neighbors]))
        nb_pts = nb_pts[smap.pt_valid[nb_pts]]
        fp_bwd = ids_b = None
        if len(nb_pts):
            lm_b, ids_b = mirror.gather(nb_pts, self._bucket(len(nb_pts)))
            fp_bwd = fuse_pool(
                pool.arrays, upload(np.array([kf_slot], np.int64), dev),
                lm_b, upload(smap.kf_pose[kf:kf + 1].astype(np.float32), dev),
                **self._tables())[0]
        arrays = [x for x in (fp_fwd, fp_bwd) if x is not None]
        if not arrays:
            return None
        # gen stamps: the pipelined flush commits one cycle late, and a
        # point slot recycled in between would alias an unrelated new point
        ctx = dict(neighbors=neighbors, ids_f=ids_f, ids_b=ids_b,
                   gen_f=(smap.pt_alloc_gen[ids_f].copy()
                          if ids_f is not None else None),
                   gen_b=(smap.pt_alloc_gen[ids_b].copy()
                          if ids_b is not None else None),
                   has_fwd=fp_fwd is not None, has_bwd=fp_bwd is not None)
        return arrays, ctx

    def commit(self, kf: int, fetched: list, ctx: dict) -> int:
        """Host commit half: merge/link duplicates from fetched results."""
        smap = self.map
        fused = 0
        fetched = list(fetched)
        if ctx["has_fwd"]:
            fp_all = fetched.pop(0)
            for bi, nb in enumerate(ctx["neighbors"]):
                fused += self._commit_fuse(fp_all[bi], ctx["ids_f"], nb,
                                           gen=ctx.get("gen_f"))
        if ctx["has_bwd"]:
            fused += self._commit_fuse(fetched.pop(0), ctx["ids_b"], kf,
                                       gen=ctx.get("gen_b"))
        smap.state += 1
        self.n_fused += fused
        return fused
