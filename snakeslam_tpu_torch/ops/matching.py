"""Batched feature matching: projection matchers, knn, rotation filter.

Counterpart of ``snakeslam_tpu/ops/matching.py`` (the reference's
SnakeORBMatcher).  Every gate (frustum, scale region, view-cos, per-octave
radius, stereo consistency, ratio test) is a broadcast mask over a dense
(P x N) score matrix, and the serial conflict-resolving commit becomes a
segment-min scatter.  Thresholds: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops.descriptors import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
INVALID_DIST = 256
_KEY_MAX = torch.iinfo(torch.int64).max


class FrameFeatures(NamedTuple):
    """Fixed-size device-side view of one frame's features (N slots)."""

    uv: torch.Tensor          # (N, 2) undistorted pixel coords
    right: torch.Tensor       # (N,) right-image x coord; < 0 if none
    octave: torch.Tensor      # (N,) int32
    angle: torch.Tensor       # (N,) degrees
    desc_bits: torch.Tensor   # (N, 256) {0,1}
    valid: torch.Tensor       # (N,) bool


class LocalMapPoints(NamedTuple):
    """Fixed-size device-side snapshot of local-map points (P slots)."""

    position: torch.Tensor    # (P, 3) world
    normal: torch.Tensor      # (P, 3) unit viewing normal
    desc_bits: torch.Tensor   # (P, 256)
    ref_depth: torch.Tensor   # (P,) reference depth for scale prediction
    ref_level: torch.Tensor   # (P,) int32 reference octave
    angle: torch.Tensor       # (P,) source keypoint angle
    valid: torch.Tensor       # (P,) bool


class ScaleTables(NamedTuple):
    """Per-octave constants."""

    scales: torch.Tensor       # (L,)
    log_scale_factor: torch.Tensor
    levels: int

    @staticmethod
    def from_pyramid(pyr, device=None) -> "ScaleTables":
        return ScaleTables(
            scales=torch.as_tensor(pyr.scales, dtype=torch.float32,
                                   device=device),
            log_scale_factor=torch.as_tensor(pyr.log_scale_factor,
                                             dtype=torch.float32,
                                             device=device),
            levels=pyr.levels,
        )


def _level_index(st: ScaleTables, level: torch.Tensor) -> torch.Tensor:
    return torch.clamp(level, 0, st.levels - 1).long()


def min_max_distance(st: ScaleTables, ref_depth, ref_level):
    """Scale-invariance region of a point (ORB-SLAM convention)."""
    max_c = ref_depth * st.scales[_level_index(st, ref_level)]
    min_d = 0.8 * max_c / st.scales[st.levels - 1]
    max_d = 1.2 * max_c
    return min_d, max_d


def predict_scale_level(st: ScaleTables, ref_depth, ref_level, dist):
    """Predicted octave of a point re-observed at distance ``dist``."""
    max_c = ref_depth * st.scales[_level_index(st, ref_level)]
    ratio = torch.clamp(max_c / torch.clamp(dist, min=1e-9), min=1e-9)
    level = torch.ceil(torch.log(ratio) / st.log_scale_factor)
    return torch.clamp(level, 0, st.levels - 1).to(torch.int32)


def _resolve_matches(best_feat: torch.Tensor, best_dist: torch.Tensor,
                     point_ok: torch.Tensor, n_features: int) -> torch.Tensor:
    """Conflict-resolving commit: each feature accepts the best point,
    minimum descriptor distance first, point index as tie-break, by a
    segment-min over int64 keys into an ``n_features + 1`` buffer per batch
    row whose last slot collects the rejected points.  Inputs are (..., P);
    leading dims are independent problems resolved in one scatter.

    Returns feat_point: (..., N) int32 winning point per feature, -1 if
    none."""
    batch = best_feat.shape[:-1]
    P = best_feat.shape[-1]
    dev = best_feat.device
    nb = 1
    for d in batch:
        nb *= d
    stride = n_features + 1
    row = torch.arange(nb, dtype=torch.int64, device=dev)[:, None] * stride
    ok = point_ok.reshape(nb, P)
    feat = best_feat.reshape(nb, P).long()
    ar = torch.arange(P, dtype=torch.int64, device=dev).expand(nb, P)
    seg = torch.where(ok, feat, n_features) + row
    key = best_dist.reshape(nb, P).long() * (P + 1) + ar
    key = torch.where(ok, key, _KEY_MAX)
    seg_min = torch.full((nb * stride,), _KEY_MAX, dtype=torch.int64,
                         device=dev)
    seg_min.scatter_reduce_(0, seg.reshape(-1), key.reshape(-1), "amin",
                            include_self=False)
    winner = ok & (key == seg_min[seg])
    scatter_idx = torch.where(winner, feat, n_features) + row
    feat_point = torch.full((nb * stride,), -1, dtype=torch.int32,
                            device=dev)
    # winners are unique per feature; only the dump slots are written twice
    feat_point[scatter_idx.reshape(-1)] = ar.reshape(-1).to(torch.int32)
    return feat_point.view(nb, stride)[:, :n_features].reshape(
        batch + (n_features,))


def _common_point_gates(lm: LocalMapPoints, frame: FrameFeatures, pose_cw,
                        cam: Pinhole, image_bounds, eps=1e-6):
    """Shared projection gates: frustum, image bounds, view-cos.

    Returns uv_p (P,2), z (P,), dist (P,), view_cos (P,), in_view (P,)."""
    xmin, ymin, xmax, ymax = image_bounds
    pc = lie.transform_points(pose_cw, lm.position)   # (..., P, 3)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    uv_p = torch.stack(
        [pc[..., 0] / zs * cam.fx + cam.cx, pc[..., 1] / zs * cam.fy + cam.cy],
        dim=-1,
    )
    cam_pos = lie.translation(lie.se3_inverse(pose_cw))
    po = cam_pos[..., None, :] - lm.position
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * lm.normal, dim=-1) / torch.clamp(dist, min=eps)
    in_view = (
        lm.valid
        & (z > 0)
        & (uv_p[..., 0] >= xmin) & (uv_p[..., 0] < xmax)
        & (uv_p[..., 1] >= ymin) & (uv_p[..., 1] < ymax)
    )
    return uv_p, z, dist, view_cos, in_view


def _candidate_mask(uv_p, z, radius, frame: FrameFeatures, oct_min, oct_max,
                    bf, feat_free):
    """(..., P, N) candidate gate: radius, octave window, stereo
    consistency."""
    dx = uv_p[..., :, None, 0] - frame.uv[..., None, :, 0]
    dy = uv_p[..., :, None, 1] - frame.uv[..., None, :, 1]
    in_radius = (dx * dx + dy * dy) < (radius[..., :, None] ** 2)
    octave = frame.octave[..., None, :]
    oct_ok = (octave >= oct_min[..., :, None]) & (
        octave <= oct_max[..., :, None])
    # stereo right-point consistency: expected u_r = u - bf / z
    expected_ur = uv_p[..., :, 0:1] - bf / torch.clamp(z[..., :, None],
                                                        min=1e-6)
    right = frame.right[..., None, :]
    stereo_ok = ~(right > 0) | (
        torch.abs(expected_ur - right) <= radius[..., :, None] * 0.5)
    return (in_radius & oct_ok & stereo_ok & frame.valid[..., None, :]
            & feat_free[..., None, :])


def _best_two(Hm: torch.Tensor):
    """Row-wise best and second-best (value, first index) of (..., P, N)."""
    best, best_idx = torch.min(Hm, dim=-1)
    Hm2 = Hm.scatter(-1, best_idx[..., None], INVALID_DIST)
    best2, best2_idx = torch.min(Hm2, dim=-1)
    return best, best_idx, best2, best2_idx


def search_by_projection_fine(
    lm: LocalMapPoints,
    frame: FrameFeatures,
    pose_cw: torch.Tensor,
    cam: Pinhole,
    bf: torch.Tensor,
    image_bounds,
    st: ScaleTables,
    feat_free: torch.Tensor,
    th: float | torch.Tensor = 1.0,
    ratio: float = 0.9,
    feature_error: int = TH_HIGH,
):
    """Local-map-point -> frame matching for fine tracking: frustum +
    scale-region + view-cos gates, viewing-cos radius, predicted octave
    window, best/second-best with the level-aware ratio test.

    ``frame``, ``feat_free`` and ``pose_cw`` may carry leading batch dims
    (one frame per row, against the same ``lm``): the whole batch is one
    pass of batched ops.

    Returns dict: feat_point (..., N) int32, visible (..., P) bool,
    n_matches (...,)."""
    uv_p, z, dist, view_cos, in_view = _common_point_gates(
        lm, frame, pose_cw, cam, image_bounds)
    min_d, max_d = min_max_distance(st, lm.ref_depth, lm.ref_level)
    in_region = (dist >= min_d) & (dist <= max_d)
    visible = in_view & in_region & (view_cos >= 0.5)

    pred = predict_scale_level(st, lm.ref_depth, lm.ref_level, dist)
    r = torch.where(view_cos > 0.998, 2.5, 4.0) * th * st.scales[pred.long()]

    cand = _candidate_mask(uv_p, z, r, frame, pred - 1, pred + 1, bf,
                           feat_free)
    cand = cand & visible[..., :, None]

    H = hamming_matrix(lm.desc_bits, frame.desc_bits)
    Hm = torch.where(cand, H, INVALID_DIST)
    best, best_idx, best2, best2_idx = _best_two(Hm)
    lvl1 = torch.gather(frame.octave, -1, best_idx)
    lvl2 = torch.gather(frame.octave, -1, best2_idx)

    ok = (best <= feature_error) & visible
    # the ratio applies only when best and second-best share an octave
    same_level = (lvl1 == lvl2) & (best2 < INVALID_DIST)
    ok = ok & (~same_level | (best.float() <= ratio * best2.float()))

    feat_point = _resolve_matches(best_idx, best, ok, frame.uv.shape[-2])
    return {
        "feat_point": feat_point,
        "visible": visible,
        "n_matches": torch.sum(feat_point >= 0, dim=-1),
    }


def search_by_projection_coarse(
    lm: LocalMapPoints,
    frame: FrameFeatures,
    pose_cw: torch.Tensor,
    cam: Pinhole,
    bf: torch.Tensor,
    image_bounds,
    st: ScaleTables,
    feat_free: torch.Tensor,
    th: float | torch.Tensor,
    feature_error: int = TH_HIGH,
    forward: torch.Tensor | None = None,
    backward: torch.Tensor | None = None,
    use_rotation_hist: bool = True,
):
    """Frame-to-frame projection matching for coarse tracking: radius =
    th * scale(last octave), octave window from forward/backward motion,
    best-only, optional rotation-histogram consistency."""
    uv_p, z, dist, view_cos, in_view = _common_point_gates(
        lm, frame, pose_cw, cam, image_bounds)
    visible = in_view & (view_cos >= 0.5)

    last_lvl = lm.ref_level
    r = th * st.scales[_level_index(st, last_lvl)]
    dev = last_lvl.device
    if forward is None:
        forward = torch.zeros((), dtype=torch.bool, device=dev)
    if backward is None:
        backward = torch.zeros((), dtype=torch.bool, device=dev)
    oct_min = torch.where(forward, last_lvl - 1,
                          torch.where(backward, torch.zeros_like(last_lvl),
                                      last_lvl - 1))
    oct_max = torch.where(forward, torch.full_like(last_lvl, 100),
                          torch.where(backward, last_lvl, last_lvl + 1))

    cand = _candidate_mask(uv_p, z, r, frame, oct_min, oct_max, bf, feat_free)
    cand = cand & visible[:, None]

    H = hamming_matrix(lm.desc_bits, frame.desc_bits)
    Hm = torch.where(cand, H, INVALID_DIST)
    best, best_idx = torch.min(Hm, dim=1)
    ok = (best <= feature_error) & visible

    feat_point = _resolve_matches(best_idx, best, ok, frame.uv.shape[0])
    if use_rotation_hist:
        feat_point = rotation_consistency_filter(feat_point, lm.angle,
                                                 frame.angle)
    return {
        "feat_point": feat_point,
        "visible": visible,
        "n_matches": torch.sum(feat_point >= 0),
    }


def rotation_consistency_filter(feat_point: torch.Tensor,
                                point_angle: torch.Tensor,
                                feat_angle: torch.Tensor) -> torch.Tensor:
    """Keep only matches whose angle difference lands in the top-3 bins of
    a 30-bin histogram (bins under 0.1 * max are dropped too)."""
    matched = feat_point >= 0
    pidx = torch.clamp(feat_point, min=0).long()
    rot = point_angle[pidx] - feat_angle
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bin_ = torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int64)
    bin_ = torch.where(bin_ >= HISTO_LENGTH, 0, bin_)
    bin_ = torch.clamp(bin_, 0, HISTO_LENGTH - 1)
    seg = torch.where(matched, bin_, HISTO_LENGTH)
    counts = torch.zeros(HISTO_LENGTH + 1, dtype=torch.int64,
                         device=feat_point.device)
    counts.scatter_add_(0, seg, torch.ones_like(seg))   # integer sums
    counts = counts[:HISTO_LENGTH]
    top3 = torch.topk(counts, 3).values
    thresh = top3[2]
    keep_bin = (counts >= torch.clamp(thresh, min=1)) & (
        counts.float() >= 0.1 * top3[0].float())
    keep = matched & keep_bin[bin_]
    return torch.where(keep, feat_point, -1)


def knn2_ratio_match(bits_a, bits_b, valid_a, valid_b, ratio: float = 0.8,
                     max_dist: int = TH_LOW, cross_check: bool = True):
    """Brute-force 2-NN Hamming matching with ratio test.

    Returns (match_idx (Na,) int into b or -1, match_dist (Na,))."""
    H = hamming_matrix(bits_a, bits_b)
    Hm = torch.where(valid_a[:, None] & valid_b[None, :], H, INVALID_DIST)
    best, best_idx, best2, _ = _best_two(Hm)
    ok = (best <= max_dist) & (best.float() <= ratio * best2.float())
    if cross_check:
        rev_best_idx = torch.min(Hm, dim=0).indices
        ok = ok & (rev_best_idx[best_idx] == torch.arange(
            Hm.shape[0], device=Hm.device))
    return (torch.where(ok, best_idx, -1).to(torch.int32),
            torch.where(ok, best, INVALID_DIST).to(torch.int32))


def knn2_ratio_match_packed_np(packed_a: np.ndarray, packed_b: np.ndarray,
                               ratio: float = 0.8, max_dist: int = TH_LOW,
                               cross_check: bool = True):
    """Host 2-NN Hamming matching on packed (n, 32) uint8 descriptors via
    the hardware popcount (``np.bitwise_count`` over 4 uint64 lanes): loop
    detection matches one (keyframe, candidate) pair of a few hundred
    points per call, which costs ~2 ms on the host.  Same contract as
    ``knn2_ratio_match_np``: returns (idx into b or -1, best distance)."""
    na, nb = len(packed_a), len(packed_b)
    if na == 0 or nb == 0:
        return (np.full(na, -1, dtype=np.int32),
                np.full(na, INVALID_DIST, dtype=np.int32))
    a64 = np.ascontiguousarray(packed_a).view(np.uint64)   # (na, 4)
    b64 = np.ascontiguousarray(packed_b).view(np.uint64)   # (nb, 4)
    dist = np.bitwise_count(
        a64[:, None, :] ^ b64[None, :, :]
    ).sum(axis=-1).astype(np.int32)                        # (na, nb)
    ar = np.arange(na)
    j1 = dist.argmin(axis=1).astype(np.int32)
    d1 = dist[ar, j1]
    if cross_check:
        rev = dist.argmin(axis=0).astype(np.int32)         # best a per b
    if nb > 1:
        saved = d1.copy()
        dist[ar, j1] = INVALID_DIST
        d2 = dist.min(axis=1)
        dist[ar, j1] = saved
    else:
        d2 = np.full(na, INVALID_DIST, dtype=np.int32)
    ok = (d1 <= max_dist) & (d1.astype(np.float32) <= ratio * d2)
    if cross_check:
        ok &= rev[j1] == ar
    idx = np.where(ok, j1, -1).astype(np.int32)
    return idx, d1


def knn2_ratio_match_np(bits_a, bits_b, ratio: float = 0.8,
                        max_dist: int = TH_LOW, cross_check: bool = True,
                        device=None):
    """Host front door for brute-force 2-NN matching of (N, 256) {0,1}
    host bit planes on ``device``.  Returns host (idx into b or -1, dist)
    of length len(bits_a)."""
    a = torch.from_numpy(np.asarray(bits_a, dtype=np.uint8)).to(device)
    b = torch.from_numpy(np.asarray(bits_b, dtype=np.uint8)).to(device)
    ones_a = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    ones_b = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    idx, dist = knn2_ratio_match(a, b, ones_a, ones_b, ratio=float(ratio),
                                 max_dist=int(max_dist),
                                 cross_check=bool(cross_check))
    return idx.cpu().numpy(), dist.cpu().numpy()
