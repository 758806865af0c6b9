"""Batched epipolar matching + triangulation between keyframe pairs.

Counterpart of ``snakeslam_tpu/ops/triangulate_pairs.py``: the whole
candidate matrix of a keyframe pair (Hamming distance, symmetric epipolar
distance, octave window, free masks) is evaluated densely, mutual-best
matches (plus a depth-grid guided second tier) are triangulated by DLT or
from an endpoint's stereo depth, and two-sided chi2 and scale-consistency
gates decide what is kept.  The neighbour fan-out is a leading pair
dimension on ``feats_b`` / ``free_b`` / ``T_b``: every pair of a dispatch
goes through one pass of batched ops, never a Python loop.

Ties: every argmin takes the first index (``torch.min`` / ``argmin`` return
the first minimal index, as ``jnp.argmin`` does), so the integer outputs
``valid`` and ``match_b`` do not depend on the device.  Nothing here reads a
device value on the host.
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops.descriptors import hamming_matrix
from snakeslam_tpu_torch.ops.matching import FrameFeatures
from snakeslam_tpu_torch.ops.triangulation import triangulate_homogeneous
from snakeslam_tpu_torch.ops.twoview import essential_matrix

FEATURE_DISTANCE = 50     # Triangulator params (LocalMapping.cpp:317-329)
EPIPOLAR_DISTANCE = 4.0   # px
ERROR_MONO = 2.1
ERROR_STEREO = 2.3


def _normalized(cam: Pinhole, uv):
    return torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy],
        dim=-1,
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (B, M, ...) at idx (B, N) -> (B, N, ...)."""
    idx = idx.long()
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    tail = x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, 1, full)


def triangulate_pairs_batch(
    feats_a: FrameFeatures,
    feats_b: FrameFeatures,     # fields with a leading pair dim B
    free_a: torch.Tensor,       # (N,) feature has no map point yet
    free_b: torch.Tensor,       # (B, M)
    T_a: torch.Tensor,          # (4, 4) world->cam
    T_b: torch.Tensor,          # (B, 4, 4)
    cam: Pinhole,
    bf: torch.Tensor,
    scales: torch.Tensor,       # (L,)
    inv_sigma2: torch.Tensor,   # (L,)
    feature_distance: int = FEATURE_DISTANCE,
    epipolar_distance: float = EPIPOLAR_DISTANCE,
    error_mono: float = ERROR_MONO,
    grid_a: torch.Tensor | None = None,   # (GH, GW) depth grid of image a
    bounds_wh: tuple = (752.0, 480.0),
    error_stereo: float = ERROR_STEREO,
    th_depth: float = 1e9,                # far-point threshold (settings)
):
    """Match unmatched features of keyframe a against each of B keyframes
    and triangulate.

    Returns dict of per-pair, per-A-feature tensors: match_b (B, N) int32
    (-1 = none), point (B, N, 3) world, valid (B, N) bool, far_away (B, N)
    bool, n_new (B,)."""
    N = feats_a.uv.shape[0]
    dev = feats_a.uv.device

    # relative geometry: xn_a^T E xn_b = 0 with T_ab = T_a @ T_b^-1
    T_ab = T_a @ lie.se3_inverse(T_b)                      # (B, 4, 4)
    E = essential_matrix(T_ab)                             # (B, 3, 3)

    xn_a = _normalized(cam, feats_a.uv)                    # (N, 2)
    xn_b = _normalized(cam, feats_b.uv)                    # (B, M, 2)

    H = hamming_matrix(feats_a.desc_bits, feats_b.desc_bits)   # (B, N, M)
    # symmetric epipolar line distance for all pairs, in pixels
    h_a = torch.cat([xn_a, torch.ones_like(xn_a[:, :1])], dim=-1)
    h_b = torch.cat([xn_b, torch.ones_like(xn_b[..., :1])], dim=-1)
    l_b = h_a @ E                                          # (B, N, 3)
    val = l_b @ h_b.mT                                     # (B, N, M)
    l_a = h_b @ E.mT                                       # (B, M, 3)
    da2 = val**2 / torch.clamp(
        (l_a[..., 0] ** 2 + l_a[..., 1] ** 2)[:, None, :], min=1e-12)
    db2 = val**2 / torch.clamp(
        (l_b[..., 0] ** 2 + l_b[..., 1] ** 2)[:, :, None], min=1e-12)
    focal2 = cam.fx * cam.fy
    epi_px2 = 0.5 * (da2 + db2) * focal2

    oct_ok = torch.abs(
        feats_a.octave[None, :, None] - feats_b.octave[:, None, :]) <= 1
    pair_ok = (
        (H <= feature_distance)
        & (epi_px2 <= epipolar_distance**2)
        & oct_ok
        & (free_a & feats_a.valid)[None, :, None]
        & (free_b & feats_b.valid)[:, None, :]
    )
    Hm = torch.where(pair_ok, H, 256)
    best, best_idx = torch.min(Hm, dim=2)                  # (B, N)
    matched = best <= feature_distance

    # mutual best check (each b feature claimed once)
    rev_best = torch.argmin(Hm, dim=1)                     # (B, M)
    ar_n = torch.arange(N, device=dev)
    matched = matched & (torch.gather(rev_best, 1, best_idx) == ar_n)

    if grid_a is not None:
        # depth-guided second tier: features the epipolar pass left
        # unmatched retry within 20 px of where the depth-completion grid
        # predicts them in image b
        GH, GW = grid_a.shape
        gx = torch.clamp((feats_a.uv[:, 0] / bounds_wh[0] * GW)
                         .to(torch.int32), 0, GW - 1).long()
        gy = torch.clamp((feats_a.uv[:, 1] / bounds_wh[1] * GH)
                         .to(torch.int32), 0, GH - 1).long()
        z = grid_a[gy, gx]
        has_z = z > 1e-6
        Pa = torch.cat([xn_a * z[:, None], z[:, None]], dim=1)
        Pb = lie.transform_points(lie.se3_inverse(T_ab), Pa)   # (B, N, 3)
        zb_pred = torch.clamp(Pb[..., 2], min=1e-6)
        uv_pred = torch.stack(
            [cam.fx * Pb[..., 0] / zb_pred + cam.cx,
             cam.fy * Pb[..., 1] / zb_pred + cam.cy], dim=-1)
        win2 = torch.sum(
            (feats_b.uv[:, None, :, :] - uv_pred[:, :, None, :]) ** 2, dim=-1)
        proj_ok = (win2 <= 20.0**2) & (has_z & (Pb[..., 2] > 0))[..., None]
        # b features claimed by the first tier stay claimed (an int amax
        # scatter: the maximum does not depend on the order)
        claimed = torch.zeros(best_idx.shape[0], feats_b.uv.shape[1],
                              dtype=torch.int32, device=dev)
        claimed.scatter_reduce_(1, best_idx, matched.to(torch.int32), "amax")
        Hm2 = torch.where(pair_ok & proj_ok & (claimed == 0)[:, None, :],
                          H, 256)
        best2, best_idx2 = torch.min(Hm2, dim=2)
        matched2 = (~matched) & (best2 <= feature_distance)
        best_idx = torch.where(matched2, best_idx2, best_idx)
        matched = matched | matched2

    xb = _take(xn_b, best_idx)                             # (B, N, 2)

    # stereo-parallax arbitration (Triangulator.cpp:199-263): the stereo
    # measurement's own parallax angle competes with the ray parallax
    disp_a = feats_a.uv[:, 0] - feats_a.right
    z_a = torch.where(feats_a.right > 0, bf / torch.clamp(disp_a, min=1e-6),
                      -1.0)                                # (N,)
    disp_b = feats_b.uv[..., 0] - feats_b.right
    z_b_all = torch.where(feats_b.right > 0,
                          bf / torch.clamp(disp_b, min=1e-6), -1.0)
    z_b = _take(z_b_all, best_idx)                         # (B, N)
    stereo1 = z_a > 0
    stereo2 = z_b > 0
    baseline = bf / cam.fx

    # ray parallax in world space from the unprojected directions
    ray1 = h_a @ T_a[:3, :3]                               # (N, 3)
    ray2 = _take(h_b, best_idx) @ T_b[:, :3, :3]           # (B, N, 3)
    cos_rays = torch.sum(ray1 * ray2, dim=-1) / torch.clamp(
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1),
        min=1e-12)
    no_stereo = cos_rays + 1.0                  # "worse than any parallax"
    cos_st1 = torch.where(
        stereo1, torch.cos(2.0 * torch.atan2(baseline / 2.0,
                                             torch.clamp(z_a, min=1e-6))),
        no_stereo)
    # reference quirk kept verbatim: stereo2's angle only when endpoint 1
    # has no stereo (the `else if`, Triangulator.cpp:204-207)
    cos_st2 = torch.where(
        (~stereo1) & stereo2,
        torch.cos(2.0 * torch.atan2(baseline / 2.0,
                                    torch.clamp(z_b, min=1e-6))),
        no_stereo)
    cos_st = torch.minimum(cos_st1, cos_st2)

    use_dlt = ((cos_rays < cos_st) & (cos_rays > 0)
               & (stereo1 | stereo2 | (cos_rays < 0.9998)))
    use_s1 = (~use_dlt) & stereo1 & (cos_st1 < cos_st2)
    use_s2 = (~use_dlt) & (~use_s1) & stereo2 & (cos_st2 < cos_st1)
    tri_ok = use_dlt | use_s1 | use_s2

    B = T_b.shape[0]
    X_dlt = triangulate_homogeneous(
        T_a.expand(B, N, 4, 4), T_b[:, None].expand(B, N, 4, 4),
        xn_a.expand(B, N, 2), xb)
    zs_a = torch.clamp(z_a, min=1e-6)
    X_s1 = lie.transform_points(
        lie.se3_inverse(T_a),
        torch.cat([xn_a * zs_a[:, None], zs_a[:, None]], dim=1))
    zs_b = torch.clamp(z_b, min=1e-6)
    X_s2 = lie.transform_points(
        lie.se3_inverse(T_b),
        torch.cat([xb * zs_b[..., None], zs_b[..., None]], dim=-1))
    X = torch.where(use_s1[..., None], X_s1,
                    torch.where(use_s2[..., None], X_s2, X_dlt))
    far_away = (use_s1 & (z_a > th_depth)) | (use_s2 & (z_b > th_depth))

    # gates (Triangulator.cpp:239-283)
    pa = lie.transform_points(T_a, X)
    pb = lie.transform_points(T_b, X)
    za, zb = pa[..., 2], pb[..., 2]
    front = (za > 1e-3) & (zb > 1e-3)

    # two-sided chi2 with per-octave sigma; stereo endpoints get the 3-dof
    # residual and the stereo threshold
    zsa = torch.where(front, za, 1.0)
    zsb = torch.where(front, zb, 1.0)
    ua = torch.stack([cam.fx * pa[..., 0] / zsa + cam.cx,
                      cam.fy * pa[..., 1] / zsa + cam.cy], dim=-1)
    ub = torch.stack([cam.fx * pb[..., 0] / zsb + cam.cx,
                      cam.fy * pb[..., 1] / zsb + cam.cy], dim=-1)
    L = scales.shape[0]
    La = torch.clamp(feats_a.octave, 0, L - 1).long()
    Lb = torch.clamp(_take(feats_b.octave, best_idx), 0, L - 1).long()
    er_a = (ua[..., 0] - bf / zsa) - feats_a.right
    er_b = (ub[..., 0] - bf / zsb) - _take(feats_b.right, best_idx)
    ea2 = (torch.sum((ua - feats_a.uv) ** 2, dim=-1)
           + torch.where(stereo1, er_a**2, 0.0)) * inv_sigma2[La]
    eb2 = (torch.sum((ub - _take(feats_b.uv, best_idx)) ** 2, dim=-1)
           + torch.where(stereo2, er_b**2, 0.0)) * inv_sigma2[Lb]
    th_a = torch.where(stereo1, error_stereo**2, error_mono**2)
    th_b = torch.where(stereo2, error_stereo**2, error_mono**2)
    chi_ok = (ea2 <= th_a) & (eb2 <= th_b)

    # scale consistency: the distance ratio must match the octave ratio
    ca = lie.translation(lie.se3_inverse(T_a))
    cb = lie.translation(lie.se3_inverse(T_b))
    dist_a = torch.linalg.norm(X - ca, dim=-1)
    dist_b = torch.linalg.norm(X - cb[:, None, :], dim=-1)
    ratio_dist = dist_a / torch.clamp(dist_b, min=1e-9)
    ratio_oct = scales[Lb] / scales[La]
    factor = 1.5 * scales[1] if L > 1 else 1.8
    scale_ok = (ratio_dist < ratio_oct * factor) & (
        ratio_dist * factor > ratio_oct)

    valid = matched & tri_ok & front & chi_ok & scale_ok
    return {
        "match_b": torch.where(valid, best_idx, -1).to(torch.int32),
        "point": X,
        "valid": valid,
        "far_away": valid & far_away,
        "n_new": torch.sum(valid, dim=-1),
    }


def triangulate_pair(feats_a: FrameFeatures, feats_b: FrameFeatures,
                     free_a, free_b, T_a, T_b, cam: Pinhole, bf, scales,
                     inv_sigma2, **kwargs):
    """One keyframe pair (no leading pair dim): ``triangulate_pairs_batch``
    with B = 1.  Returns match_b (N,), point (N, 3), valid (N,),
    far_away (N,), n_new ()."""
    out = triangulate_pairs_batch(
        feats_a, FrameFeatures(*(f[None] for f in feats_b)), free_a,
        free_b[None], T_a, T_b[None], cam, bf, scales, inv_sigma2, **kwargs)
    return {k: v[0] for k, v in out.items()}
