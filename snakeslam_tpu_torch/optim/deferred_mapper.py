"""Deferred mapping: late refinement of stabilized keyframes.

Counterpart of ``snakeslam_tpu/optim/deferred_mapper.py`` (the reference's
DeferredMapper, queue delay 9) — once a keyframe's pose has stabilized:
  * Relink (:39-165): move each observation to a better-fitting keypoint
    within 0.8 px of the reprojection, and drop observations with
    reprojection error above 2.1 px (scale-weighted).
  * MapSearch (:167-178): stricter re-fuse against older keyframes.
  * Retriangulate (:180-225): re-run triangulation with tightened gates
    (0.8x reprojection threshold, 1.2 px epipolar), then cull newly created
    points left with <= 2 observations.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.core.pyramid import ScalePyramid
from snakeslam_tpu_torch.map.slam_map import SlamMap
from snakeslam_tpu_torch.system.settings import Settings
from snakeslam_tpu_torch.tracking.staging import HostCopy

RELINK_RADIUS = 0.8
OUTLIER_ERROR = 2.1


class DeferredMapper:
    def __init__(self, settings: Settings, smap: SlamMap, map_searcher=None,
                 local_mapper=None):
        self.s = settings
        self.map = smap
        self.map_searcher = map_searcher
        self.local_mapper = local_mapper
        self.pyramid = ScalePyramid.create(settings.fd_levels,
                                           settings.fd_scale_factor)
        self.n_relinked = 0
        self.n_removed = 0

    def add(self, kf: int):
        self.process(kf)

    # ------------------------------------------------------------------

    def process(self, kf: int):
        if not self.map.kf_valid[kf]:
            return
        self.relink(kf)
        # the two device stages queued together against the post-relink
        # snapshot, then one readback for both: the tight triangulation
        # does not see this pass's fusion merges (the stale-snapshot
        # compute the rest of the mapping pipeline accepts); the commits
        # stay in reference order: fuse first, then triangulate + cull
        fuse = (self.map_searcher.dispatch(kf)
                if self.map_searcher is not None else None)
        tri = None
        if self.local_mapper is not None:
            tri = self.local_mapper._tri_dispatch(
                kf, num_neighbors=10,
                feature_distance=40, epipolar_distance=1.2,
                error_mono=0.8 * OUTLIER_ERROR,
            )
        arrays = list(fuse[0]) if fuse is not None else []
        if tri is not None:
            arrays += [tri[0]["valid"], tri[0]["match_b"], tri[0]["point"]]
        fetched = HostCopy(arrays).wait()
        if fuse is not None:
            nf = len(fuse[0])
            self.map_searcher.commit(kf, fetched[:nf], fuse[1])
            del fetched[:nf]
        if tri is not None:
            before = {int(p) for p in self.map.keyframe_points(kf)}
            self.local_mapper._tri_commit(
                kf, fetched[0], fetched[1],
                fetched[2].astype(np.float64), tri[1])
            for pt in self.map.keyframe_points(kf):
                pt = int(pt)
                if pt not in before and self.map.pt_n_obs[pt] <= 2:
                    # newly created and weakly observed: cull
                    self.map.erase_point(pt)

    # ------------------------------------------------------------------

    def relink(self, kf: int):
        """Reproject every observed point; relink to the closest keypoint
        within RELINK_RADIUS, drop residuals above OUTLIER_ERROR px."""
        smap = self.map
        n = int(smap.kf_n_feat[kf])
        feats = np.nonzero(smap.kf_obs[kf, :n] >= 0)[0]
        if len(feats) == 0:
            return
        pts = smap.kf_obs[kf, feats]
        T = smap.kf_pose[kf]
        pc = smap.pt_pos[pts] @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        ok = z > 1e-4
        u = self.s.fx * pc[:, 0] / np.maximum(z, 1e-4) + self.s.cx
        v = self.s.fy * pc[:, 1] / np.maximum(z, 1e-4) + self.s.cy
        uv_all = smap.kf_feat_uv[kf, :n]
        scales = np.asarray(self.pyramid.scales)
        # vectorized classification; only the few mutations remain scalar
        proj = np.stack([u, v], axis=1)                      # (F, 2)
        err = np.linalg.norm(uv_all[feats] - proj, axis=1)   # (F,)
        octv = np.minimum(smap.kf_feat_octave[kf, feats], len(scales) - 1)
        alive = ok & smap.pt_valid[pts]
        outlier = alive & (err > OUTLIER_ERROR * scales[octv])
        keep = alive & ~outlier
        # nearest keypoint per kept feature: (F_keep, N) distance matrix
        kidx = np.nonzero(keep)[0]
        if len(kidx):
            d2 = ((uv_all[None, :, :] - proj[kidx][:, None, :]) ** 2
                  ).sum(axis=2)                              # (F_keep, N)
            d2[np.arange(len(kidx)), feats[kidx]] = np.inf
            best = d2.argmin(axis=1)
            bestd = np.sqrt(d2[np.arange(len(kidx)), best])
            relink = ((bestd < RELINK_RADIUS) & (bestd < err[kidx])
                      & (smap.kf_obs[kf, best] < 0))
        for i in np.nonzero(~alive)[0]:
            smap.remove_observation(kf, int(feats[i]))
            self.n_removed += 1
        for i in np.nonzero(outlier)[0]:
            smap.remove_observation(kf, int(feats[i]))
            pt_i = int(pts[i])
            if smap.pt_n_obs[pt_i] < 2:
                smap.erase_point(pt_i)
            self.n_removed += 1
        if len(kidx):
            for j in np.nonzero(relink)[0]:
                i = kidx[j]
                if smap.kf_obs[kf, best[j]] >= 0:
                    continue     # an earlier relink took the slot
                smap.remove_observation(kf, int(feats[i]))
                smap.add_observation(kf, int(best[j]), int(pts[i]))
                self.n_relinked += 1
        smap.state += 1
