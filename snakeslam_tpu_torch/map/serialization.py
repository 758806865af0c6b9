"""Map checkpoint / resume: full map serialization to npz.

The reference has no full map serialization (SURVEY.md §5 checkpoint) —
only the feature cache and the imgui "Save Scene" export of frames + poses
(reference: Snake/System/System.cpp:479-519).  This module provides both:
a complete SlamMap checkpoint (all pools + observation tables) for
resume, and the scene export (poses + points) for downstream consumers.

Counterpart of ``snakeslam_tpu/map/serialization.py`` with the same npz
field names, so each package loads the other's checkpoints.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.map.slam_map import SlamMap

_KF_FIELDS = [
    "kf_valid", "kf_pose", "kf_timestamp", "kf_frame_id", "kf_prev",
    "kf_next", "kf_parent", "kf_cull_factor", "kf_median_depth",
    "kf_velocity", "kf_bias_gyro", "kf_bias_acc", "kf_n_feat", "kf_obs",
    "kf_feat_uv", "kf_feat_right", "kf_feat_depth", "kf_feat_octave",
    "kf_feat_angle", "kf_feat_desc",
]
_PT_FIELDS = [
    "pt_valid", "pt_pos", "pt_normal", "pt_desc", "pt_bits", "pt_ref_kf",
    "pt_ref_depth", "pt_ref_level", "pt_found", "pt_visible", "pt_first_kf",
    "pt_obs_kf", "pt_obs_feat", "pt_n_obs", "pt_alloc_gen",
]


def save_map(smap: SlamMap, path):
    """Write the full map state as a compressed npz checkpoint."""
    data = {f: getattr(smap, f) for f in _KF_FIELDS + _PT_FIELDS}
    data["_caps"] = np.array(
        [smap.max_keyframes, smap.max_points, smap.max_features]
    )
    data["_alloc"] = np.array([smap._next_kf, smap._next_pt, smap.state])
    data["_free_kfs"] = np.array(smap._free_kfs, dtype=np.int64)
    data["_free_pts"] = np.array(smap._free_pts, dtype=np.int64)
    np.savez_compressed(path, **data)


def load_map(path) -> SlamMap:
    z = np.load(path)
    caps = z["_caps"]
    smap = SlamMap(int(caps[0]), int(caps[1]), int(caps[2]))
    for f in _KF_FIELDS + _PT_FIELDS:
        if f in z:  # older checkpoints may predate a field (e.g. alloc gen)
            getattr(smap, f)[...] = z[f]
    alloc = z["_alloc"]
    smap._next_kf, smap._next_pt, smap.state = (
        int(alloc[0]), int(alloc[1]), int(alloc[2])
    )
    smap._free_kfs = [int(v) for v in z["_free_kfs"]]
    smap._free_pts = [int(v) for v in z["_free_pts"]]
    return smap


def export_scene(smap: SlamMap, path):
    """'Save Scene' analog: keyframe poses + point cloud as npz."""
    ks = smap.valid_keyframes()
    ps = smap.valid_points()
    np.savez_compressed(
        path,
        kf_ids=ks,
        kf_pose=smap.kf_pose[ks],
        kf_timestamp=smap.kf_timestamp[ks],
        points=smap.pt_pos[ps],
        point_normals=smap.pt_normal[ps],
        point_n_obs=smap.pt_n_obs[ps],
    )
