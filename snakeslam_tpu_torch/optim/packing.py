"""Vectorized BA problem packing from the map's bounded observation tables.

The per-point observation slots (SlamMap.pt_obs_kf/pt_obs_feat) are already
a fixed-shape table, so building the (P, M) BA observation arrays is pure
numpy gather — no Python loops over points.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.map.slam_map import MAX_OBS, SlamMap

F32 = np.float32


def pack_observations(smap: SlamMap, pts: np.ndarray, slot_of_kf: np.ndarray,
                      P: int, M: int, inv_scale: np.ndarray):
    """Build (P, M) observation arrays for point ids `pts`.

    Args:
      slot_of_kf: (max_keyframes,) kf id -> camera slot, -1 if not packed.
    Returns dict of arrays + bookkeeping (kf ids / feature slots per obs for
    outlier erasure).
    """
    n = len(pts)
    src_kf = smap.pt_obs_kf[pts]              # (n, MAX_OBS)
    src_feat = smap.pt_obs_feat[pts]
    slot = np.where(src_kf >= 0, slot_of_kf[np.maximum(src_kf, 0)], -1)
    valid = (src_kf >= 0) & (slot >= 0)

    # stable-select the first M valid observations per row
    order = np.argsort(~valid, axis=1, kind="stable")[:, :M]
    rows = np.arange(n)[:, None]
    sel_kf = np.take_along_axis(src_kf, order, axis=1)
    sel_feat = np.take_along_axis(src_feat, order, axis=1)
    sel_slot = np.take_along_axis(slot, order, axis=1)
    sel_valid = np.take_along_axis(valid, order, axis=1)

    k = np.maximum(sel_kf, 0)
    f = np.maximum(sel_feat, 0)
    obs_uv_n = smap.kf_feat_uv[k, f]
    obs_right_n = smap.kf_feat_right[k, f]
    octv = np.clip(smap.kf_feat_octave[k, f], 0, len(inv_scale) - 1)
    obs_w_n = inv_scale[octv]

    obs_cam = np.full((P, M), -1, dtype=np.int32)
    obs_uv = np.zeros((P, M, 2), dtype=F32)
    obs_right = np.full((P, M), -1.0, dtype=F32)
    obs_weight = np.ones((P, M), dtype=F32)
    obs_valid = np.zeros((P, M), dtype=bool)
    obs_kf_id = np.full((P, M), -1, dtype=np.int32)
    obs_feat = np.full((P, M), -1, dtype=np.int32)

    obs_cam[:n] = np.where(sel_valid, sel_slot, -1)
    obs_uv[:n] = np.where(sel_valid[..., None], obs_uv_n, 0.0)
    obs_right[:n] = np.where(sel_valid, obs_right_n, -1.0)
    obs_weight[:n] = np.where(sel_valid, obs_w_n, 1.0)
    obs_valid[:n] = sel_valid
    obs_kf_id[:n] = np.where(sel_valid, sel_kf, -1)
    obs_feat[:n] = np.where(sel_valid, sel_feat, -1)

    return dict(
        obs_cam=obs_cam, obs_uv=obs_uv, obs_right=obs_right,
        obs_weight=obs_weight, obs_valid=obs_valid,
        obs_kf_id=obs_kf_id, obs_feat=obs_feat,
    )


def erase_outlier_observations(smap: SlamMap, pts: np.ndarray,
                               outliers: np.ndarray, obs_kf_id: np.ndarray,
                               obs_feat: np.ndarray, obs_valid: np.ndarray,
                               min_obs: int = 2) -> int:
    """Remove chi2-outlier observations; drop points left under-observed."""
    removed = 0
    for pi, mi in zip(*np.nonzero(outliers & obs_valid)):
        if pi >= len(pts):
            continue
        k = int(obs_kf_id[pi, mi])
        f = int(obs_feat[pi, mi])
        if k < 0 or f < 0:
            continue
        pt = int(pts[pi])
        # the observation may have been rewired (point replaced by fusion)
        # between pack and commit — only erase if it still belongs to the
        # packed point
        if smap.kf_obs[k, f] != pt:
            continue
        smap.remove_observation(k, f)
        if smap.pt_n_obs[pt] < min_obs:
            smap.erase_point(pt)
        removed += 1
    return removed
