"""Per-frame tracking steps: coarse and fine.

Counterpart of ``snakeslam_tpu/models/tracking_step.py``.  Used for the
frames the windowed scan does not track: the first frame after
initialization and chain restarts after a tracking failure.  Each step is
projection matching + robust pose refine with the motion prior; results
stay on the device until the tracker reads them.

On the card each step is a compiled program (``utils/graphs.py``), as the
JAX package jits them: one captured CUDA graph replayed per call, keyed by
the local map's fixed width and ``use_rotation_hist``.  The plain
``robust_pose_refine`` stays in them, as in the JAX package: its 6x6 solve
is closed-form, so it captures.  A replay returns the graph's static
outputs, valid until the step's next call; the tracker copies ``packed``
to the host at once and hands ``T`` to the fine step before then.
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops import matching as M
from snakeslam_tpu_torch.ops.pose_solver import PoseObs, robust_pose_refine
from snakeslam_tpu_torch.utils import graphs

# tracking constants (reference: Snake/Tracking/Tracking.h:181-189)
COARSE_MIN_INLIERS_LAST_FRAME = 20
COARSE_FEATURE_TH = 75


def _weights_from_octave(octave, inv_scales):
    """Observation weight = 1/scale(octave)."""
    return inv_scales[torch.clamp(octave, 0, inv_scales.shape[0] - 1).long()]


def _scale_tables(scales, log_scale_factor):
    return M.ScaleTables(scales=scales, log_scale_factor=log_scale_factor,
                         levels=scales.shape[0])


def _coarse_step(
    lm: M.LocalMapPoints,
    frame: M.FrameFeatures,
    T_pred: torch.Tensor,
    cam: Pinhole,
    bf: torch.Tensor,
    image_bounds: torch.Tensor,
    scales: torch.Tensor,
    log_scale_factor: torch.Tensor,
    radius: torch.Tensor,
    prior_weight_rotation: torch.Tensor,
    prior_weight_translation: torch.Tensor,
    use_rotation_hist: bool = True,
):
    """Coarse tracking: frame-frame projection match + robust pose refine.

    Returns dict: T (4,4), assign (N,), inlier (N,), n_matches, n_inliers,
    ok, and ``packed`` (one flat f32 row for a single device->host copy)."""
    st = _scale_tables(scales, log_scale_factor)
    bounds = tuple(image_bounds[k] for k in range(4))
    kw = dict(feat_free=frame.valid, feature_error=COARSE_FEATURE_TH,
              use_rotation_hist=use_rotation_hist)
    out1 = M.search_by_projection_coarse(lm, frame, T_pred, cam, bf, bounds,
                                         st, th=radius, **kw)
    # retry with doubled radius when too few matches
    out2 = M.search_by_projection_coarse(lm, frame, T_pred, cam, bf, bounds,
                                         st, th=2.0 * radius, **kw)
    retry = out1["n_matches"] < COARSE_MIN_INLIERS_LAST_FRAME
    assign = torch.where(retry, out2["feat_point"], out1["feat_point"])
    n_matches = torch.where(retry, out2["n_matches"], out1["n_matches"])

    matched = assign >= 0
    pidx = torch.clamp(assign, 0, lm.position.shape[0] - 1).long()
    obs = PoseObs(
        points=lm.position[pidx], uv=frame.uv, right=frame.right,
        weight=_weights_from_octave(frame.octave, 1.0 / scales),
        mask=matched,
    )
    T, inlier, n_inl = robust_pose_refine(
        T_pred, obs, cam, bf, prior_T=T_pred,
        prior_weight_rotation=prior_weight_rotation,
        prior_weight_translation=prior_weight_translation,
    )
    assign = torch.where(inlier, assign, -1)
    ok = (n_matches >= COARSE_MIN_INLIERS_LAST_FRAME) & (
        n_inl >= COARSE_MIN_INLIERS_LAST_FRAME)
    packed = torch.cat([
        T.reshape(-1).float(),
        torch.stack([n_matches.float(), n_inl.float(), ok.float()]),
        assign.float(),
    ])
    return {"T": T, "assign": assign, "inlier": inlier,
            "n_matches": n_matches, "n_inliers": n_inl, "ok": ok,
            "packed": packed}


def _fine_step(
    lm: M.LocalMapPoints,
    frame: M.FrameFeatures,
    T_coarse: torch.Tensor,
    coarse_pos: torch.Tensor,
    coarse_matched: torch.Tensor,
    cam: Pinhole,
    bf: torch.Tensor,
    image_bounds: torch.Tensor,
    scales: torch.Tensor,
    log_scale_factor: torch.Tensor,
    th: torch.Tensor,
    prior_T: torch.Tensor,
    prior_weight_rotation: torch.Tensor,
    prior_weight_translation: torch.Tensor,
):
    """Fine tracking: local-map projection match + pose refine + the
    found/visible statistics.

    Returns dict: T, fine_assign (N,), inlier (N,), matched, n_inliers,
    visible (P,), found (P,), and ``packed``."""
    st = _scale_tables(scales, log_scale_factor)
    bounds = tuple(image_bounds[k] for k in range(4))
    out = M.search_by_projection_fine(
        lm, frame, T_coarse, cam, bf, bounds, st,
        feat_free=frame.valid & (~coarse_matched), th=th, ratio=0.8,
    )
    fine_assign = out["feat_point"]
    fine_matched = fine_assign >= 0
    P = lm.position.shape[0]
    pidx = torch.clamp(fine_assign, 0, P - 1).long()
    pos = torch.where(coarse_matched[:, None], coarse_pos, lm.position[pidx])
    matched = coarse_matched | fine_matched
    obs = PoseObs(
        points=pos, uv=frame.uv, right=frame.right,
        weight=_weights_from_octave(frame.octave, 1.0 / scales),
        mask=matched,
    )
    T, inlier, n_inl = robust_pose_refine(
        T_coarse, obs, cam, bf, prior_T=prior_T,
        prior_weight_rotation=prior_weight_rotation,
        prior_weight_translation=prior_weight_translation,
    )
    visible = out["visible"]
    found = torch.zeros(P + 1, dtype=torch.bool, device=pos.device)
    # index_fill_ takes the value as a kernel argument: a Python number
    # written by indexing is copied from the host, which cannot be captured
    found.index_fill_(0, torch.where(fine_matched & inlier, fine_assign,
                                     P).long(), True)
    found = found[:P]
    fine_assign_out = torch.where(inlier, fine_assign, -1)
    packed = torch.cat([
        T.reshape(-1).float(),
        n_inl.float()[None],
        fine_assign_out.float(),
        inlier.float(),
        visible.float(),
        found.float(),
    ])
    return {"T": T, "fine_assign": fine_assign_out, "inlier": inlier,
            "matched": matched, "n_inliers": n_inl, "visible": visible,
            "found": found, "packed": packed}


coarse_step = graphs.compiled(_coarse_step, static=("use_rotation_hist",),
                              name="coarse_step")
fine_step = graphs.compiled(_fine_step, name="fine_step")
