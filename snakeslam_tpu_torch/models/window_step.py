"""Windowed tracking step: W frames tracked in one device-side loop.

Counterpart of ``snakeslam_tpu/models/window_step.py``.  The JAX package
compiles the window as one ``lax.scan``; here it is a Python loop over the
W frames whose carry (pose, velocity, keyframe-decision state, stopped
flag) and per-frame flags stay device tensors combined with
``torch.where``, so the loop never waits for the device.  Per frame:
constant-velocity prediction (with ``use_imu`` its rotation is replaced by
the gyro-predicted one the packed row carries) -> coarse projection
matching -> robust pose refine (1 x 3) -> fine projection matching ->
robust pose refine (2 x 2) -> in-loop keyframe decision against a carried
virtual-keyframe state.  With ``two_stage=False`` one fine search of twice
the radius from the predicted pose replaces the coarse stage.

The robust pose refine is chosen by the device of the tensors: on CUDA the
fused CUDA kernel (ops/pose_fused.py), on the CPU ``robust_pose_refine``,
as the JAX package does off the TPU.

Frame payloads travel as one flat f32 buffer with descriptor bytes
bit-cast into f32 lanes; that region is only sliced and re-viewed as
bytes, never passed through arithmetic or ``torch.where``.  Frame times
are packed relative to a per-chain origin ``t0`` (``time_origin``): a
float32 row cannot hold a unix time (~1.3e9 s, a float32 step of 128 s)
to the half second the keyframe time rule needs.

On the card ``window_track`` is a compiled program (``utils/graphs.py``):
one captured CUDA graph replayed per window, keyed by (W, ``n_slots``, the
snapshot bucket P, ``two_stage``, ``use_imu``); every input is a tensor,
as in the JAX signature, so one graph serves every window of a key.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops import matching as M
from snakeslam_tpu_torch.ops.descriptors import unpack_bits
from snakeslam_tpu_torch.ops.pose_fused import pose_refine_fused
from snakeslam_tpu_torch.ops.pose_solver import PoseObs, robust_pose_refine
from snakeslam_tpu_torch.utils import graphs

# packed frame layout (per frame, all f32):
#   uv (N,2) | right (N,) | octave (N,) | angle (N,) | packed desc (N,8
#   f32-bitcast of 32 uint8) | n_valid (1) | timestamp (1) | dR_imu (9)
FRAME_SCALARS = 2 + 9

# keyframe-decision carry layout:
#   [0] last-KF match count  [1] last-KF timestamp  [2:5] last-KF camera
#   center  [5:8] last-KF view direction  [8] median scene depth
#   [9] frames since last KF
DEC_SIZE = 10


TIME_ORIGIN_STEP = 1024.0   # s: t0 is a multiple of it


def frame_buffer_width(n_slots: int) -> int:
    return n_slots * (2 + 1 + 1 + 1 + 8) + FRAME_SCALARS


def time_origin(t_first: float) -> float:
    """The origin packed frame times are taken from, for a chain whose
    first frame is at ``t_first`` s: ``1024 * floor(t_first / 1024)``, in
    float64 on the host.  Below 1024 s it is 0, so a synthetic lane packs
    the same bits as the JAX package; at unix times the packed residual
    stays below 1024 s, a float32 step of ~6e-5 s."""
    return TIME_ORIGIN_STEP * math.floor(t_first / TIME_ORIGIN_STEP)


def _pack_one_np(f, n_slots: int, t0: float = 0.0) -> np.ndarray:
    """Pack one FrameData into its (K,) f32 row, its time relative to
    ``t0`` (cached on the frame; the cache is invalid when the gyro
    prediction or the time origin changed since)."""
    cache = getattr(f, "_packed_row", None)
    dR = getattr(f, "imu_dR_cam", None)
    if (cache is not None and cache.shape[0] == frame_buffer_width(n_slots)
            and getattr(f, "_packed_dR", None) is dR
            and getattr(f, "_packed_t0", None) == t0):
        return cache
    n = min(f.n, n_slots)
    row = np.zeros(frame_buffer_width(n_slots), dtype=np.float32)
    o = 0
    row[o:o + n * 2] = np.asarray(f.uv[:n], np.float32).ravel()
    o += n_slots * 2
    row[o:o + n] = f.right[:n]
    row[o + n:o + n_slots] = -1.0
    o += n_slots
    row[o:o + n] = f.octave[:n]
    o += n_slots
    row[o:o + n] = f.angle[:n]
    o += n_slots
    row[o:o + n * 8] = np.ascontiguousarray(
        f.descriptors[:n], dtype=np.uint8).view(np.float32).ravel()
    o += n_slots * 8
    row[o] = n
    row[o + 1] = f.timestamp - t0
    row[o + 2:o + 11] = (np.eye(3, dtype=np.float32).ravel()
                         if dR is None
                         else np.asarray(dR, np.float32).ravel())
    f._packed_row = row
    f._packed_dR = dR
    f._packed_t0 = t0
    return row


def pack_frames_np(frames, n_slots: int, out: np.ndarray | None = None,
                   t0: float = 0.0):
    """Host-side packing of a FrameData list -> (W, K) f32 buffer, written
    into ``out`` (e.g. a pinned staging buffer) when given; frame times
    relative to ``t0`` (``time_origin``)."""
    rows = [_pack_one_np(f, n_slots, t0) for f in frames]
    if out is None:
        return np.stack(rows)
    np.stack(rows, out=out)
    return out


def make_dec_state(last_kf_matches: float, last_kf_time: float,
                   last_kf_center: np.ndarray, last_kf_viewdir: np.ndarray,
                   median_depth: float, frames_since_kf: int) -> np.ndarray:
    """Host-side construction of the keyframe-decision carry vector
    (``last_kf_time`` relative to the chain's time origin)."""
    dec = np.zeros(DEC_SIZE, dtype=np.float32)
    dec[0] = last_kf_matches
    dec[1] = last_kf_time
    dec[2:5] = last_kf_center
    dec[5:8] = last_kf_viewdir
    dec[8] = median_depth
    dec[9] = frames_since_kf
    return dec


def _unpack_frame(buf: torch.Tensor, n_slots: int):
    o = 0
    uv = buf[o:o + n_slots * 2].reshape(n_slots, 2); o += n_slots * 2
    right = buf[o:o + n_slots]; o += n_slots
    octave = buf[o:o + n_slots].to(torch.int32); o += n_slots
    angle = buf[o:o + n_slots]; o += n_slots
    # bit-cast region: slice + byte view only
    packed_desc = buf[o:o + n_slots * 8].view(torch.uint8).reshape(n_slots, 32)
    bits = unpack_bits(packed_desc).to(torch.int8)
    o += n_slots * 8
    n_valid = buf[o].to(torch.int32)
    ts = buf[o + 1]
    dR_imu = buf[o + 2:o + 11].reshape(3, 3)
    valid = torch.arange(n_slots, device=buf.device) < n_valid
    return M.FrameFeatures(uv=uv, right=right, octave=octave, angle=angle,
                           desc_bits=bits, valid=valid), ts, dR_imu


def _window_track(
    lm: M.LocalMapPoints,
    frames_buf: torch.Tensor,       # (W, K) packed frames
    T_last: torch.Tensor,           # (4, 4) pose of the previous frame
    velocity: torch.Tensor,         # (4, 4) camera-space motion model
    dec_state: torch.Tensor,        # (DEC_SIZE,) keyframe-decision carry
    stopped_in: torch.Tensor,       # () bool: chain already failed upstream
    cam: Pinhole,
    bf: torch.Tensor,
    image_bounds: torch.Tensor,     # (4,)
    scales: torch.Tensor,
    log_scale_factor: torch.Tensor,
    coarse_radius: torch.Tensor,
    fine_th: torch.Tensor,
    kfi_target: torch.Tensor,       # () target matches
    is_stereo: torch.Tensor,        # () bool
    th_depth: torch.Tensor,         # () close-point threshold
    n_valid_frames: torch.Tensor,   # () unpadded window length
    med_override: torch.Tensor | None = None,  # () refreshed median
                                    # depth; <= 0 (or None): keep the carry's
    n_slots: int = 1024,
    two_stage: bool = True,
    use_imu: bool = False,
):
    """Track up to W frames against one local-map snapshot.

    Returns ``(outs, assign, vis, fnd, carry)`` where
      outs   (W, 24) f32: [0:16] pose, [16] n_inliers, [17] ok,
             [18] need_kf, [19] stopped-before-this-frame, [20:24] reserved
      assign (W, N) int16: local-map index per feature (-1 = unmatched)
      vis    (P,) int32: per-point visible counts over tracked frames
      fnd    (P,) int32: per-point found counts over tracked frames
      carry  (T, velocity, dec_state, stopped) device tensors that chain
             the next window with no host round trip.
    """
    dev = frames_buf.device
    st = M.ScaleTables(scales=scales, log_scale_factor=log_scale_factor,
                       levels=scales.shape[0])
    bounds = tuple(image_bounds[k] for k in range(4))
    P = lm.position.shape[0]
    inv_scales = 1.0 / scales
    use_fused = dev.type == "cuda"

    def _refine(T0, obs, outer_iters, inner_iters):
        if use_fused:
            return pose_refine_fused(
                T0, obs.points, obs.uv, obs.right, obs.weight, obs.mask,
                cam, bf, outer_iters=outer_iters, inner_iters=inner_iters)
        return robust_pose_refine(T0, obs, cam, bf, outer_iters=outer_iters,
                                  inner_iters=inner_iters)

    def track_one(T_pred, frame):
        weight = inv_scales[torch.clamp(frame.octave, 0, st.levels - 1).long()]
        if two_stage:
            # coarse: prediction-radius matching against the snapshot
            outc = M.search_by_projection_coarse(
                lm, frame, T_pred, cam, bf, bounds, st,
                feat_free=frame.valid, th=coarse_radius, feature_error=75,
                use_rotation_hist=False,
            )
            assign_c = outc["feat_point"]
            matched_c = assign_c >= 0
            pidx = torch.clamp(assign_c, 0, P - 1).long()
            obs = PoseObs(points=lm.position[pidx], uv=frame.uv,
                          right=frame.right, weight=weight, mask=matched_c)
            T1, _, _ = _refine(T_pred, obs, 1, 3)
            # fine: tighter radius from the refined pose
            outf = M.search_by_projection_fine(
                lm, frame, T1, cam, bf, bounds, st,
                feat_free=frame.valid & (~matched_c), th=fine_th, ratio=0.8,
            )
            assign_f = outf["feat_point"]
            matched = matched_c | (assign_f >= 0)
            assign = torch.where(matched_c, assign_c, assign_f)
        else:
            # single-stage: the prediction is excellent within a window, so
            # one wider fine search replaces coarse + fine (half the GN
            # steps)
            T1 = T_pred
            outf = M.search_by_projection_fine(
                lm, frame, T_pred, cam, bf, bounds, st,
                feat_free=frame.valid, th=2.0 * fine_th, ratio=0.8,
            )
            assign = outf["feat_point"]
            matched = assign >= 0
        pidx = torch.clamp(assign, 0, P - 1).long()
        obs = PoseObs(points=lm.position[pidx], uv=frame.uv,
                      right=frame.right, weight=weight, mask=matched)
        T2, inlier, n2 = _refine(T1, obs, 2, 2)
        assign = torch.where(inlier, assign, -1)
        # found counts: a sum of ones, so the (atomic) order of index_add_
        # on the device cannot change the result
        found = torch.zeros(P + 1, dtype=torch.float32, device=dev)
        found.index_add_(0, torch.where(assign >= 0, assign, P).long(),
                         torch.ones(assign.shape[0], device=dev))
        return T2, assign, n2, outf["visible"].float(), found[:P]

    zaxis = torch.eye(3, dtype=torch.float32, device=dev)[2]

    def kf_decision(T, n_inl, ts, frame, assign, dec):
        """KeyframeDecision.cpp rules on the device against the carried
        (virtual) last-keyframe state."""
        last_kf_matches = dec[0]
        last_kf_time = dec[1]
        last_kf_center = dec[2:5]
        last_kf_viewdir = dec[5:8]
        median_depth = dec[8]
        frames_since_kf = dec[9] + 1.0

        current = n_inl
        has_right = frame.right > 0
        close = (assign >= 0) & has_right
        depth_est = torch.where(
            has_right,
            bf / torch.clamp(frame.uv[:, 0] - frame.right, min=1e-3),
            torch.full_like(frame.right, 1e9))
        close = close & (depth_est <= th_depth)
        n_close = torch.sum(close)
        n_nonclose = torch.sum(assign >= 0) - n_close
        need_stereo = is_stereo & (n_close < 90) & (n_nonclose > 60)
        current = torch.where(is_stereo, current - n_nonclose, current)

        target_ratio = current.float() / kfi_target
        kf_ratio = current.float() / torch.clamp(last_kf_matches, min=1.0)
        time_rule = (ts - last_kf_time) >= 0.5

        cam_center = -(T[:3, :3].T @ T[:3, 3])
        baseline = torch.linalg.norm(cam_center - last_kf_center)
        trans_angle = torch.rad2deg(torch.atan2(
            baseline / 2.0, torch.clamp(median_depth, min=1e-6)))
        viewdir = T[:3, :3].T @ zaxis
        rot_angle = torch.rad2deg(torch.arccos(torch.clamp(
            torch.sum(viewdir * last_kf_viewdir), -1.0, 1.0)))

        super_bad = current < 50
        bad = (current < 60) | (target_ratio < 0.5) | (kf_ratio < 0.6)
        very_good = target_ratio >= 1.3
        good = (target_ratio >= 0.8) | (kf_ratio > 2.0)
        geometry = (trans_angle > 1.0) | (rot_angle > 15.0)
        geometry_bad = bad & ((trans_angle > 1.0) | (rot_angle > 10.0))
        frames_rule = (frames_since_kf > 30) & (trans_angle > 0.5)

        need = time_rule | need_stereo
        need = need | (~super_bad & ~very_good
                       & (frames_rule | (~good & geometry) | geometry_bad))
        # virtual-keyframe reset (the host refreshes the median depth when
        # the chain picks up the real insertion)
        dec_fired = torch.cat([
            torch.stack([n_inl.float(), ts]),
            cam_center, viewdir,
            torch.stack([median_depth, torch.zeros_like(median_depth)]),
        ]).to(dec.dtype)
        dec_pass = torch.cat([dec[:9], frames_since_kf[None]])
        return need, torch.where(need, dec_fired, dec_pass)

    n_valid_frames = torch.as_tensor(n_valid_frames, device=dev)
    if med_override is not None:
        # the host refreshed the median depth after a keyframe commit
        med_override = torch.as_tensor(med_override, dtype=dec_state.dtype,
                                       device=dev)
        dec_state = torch.cat([
            dec_state[:8],
            torch.where(med_override > 0, med_override, dec_state[8])[None],
            dec_state[9:]])

    T_last_c, vel, dec, stopped = T_last, velocity, dec_state, stopped_in
    W = frames_buf.shape[0]
    outs, assigns = [], []
    vis_sum = torch.zeros(P, dtype=torch.float32, device=dev)
    fnd_sum = torch.zeros(P, dtype=torch.float32, device=dev)
    pad_row = torch.zeros(4, dtype=torch.float32, device=dev)
    for w in range(W):
        frame, ts, dR_imu = _unpack_frame(frames_buf[w], n_slots)
        T_pred = vel @ T_last_c
        if use_imu:
            # gyro-predicted rotation, constant-velocity translation
            # (TrackingCoarse.cpp:322-327 prediction split)
            T_pred = lie.orthonormalize(
                lie.se3(dR_imu @ T_last_c[:3, :3], T_pred[:3, 3]))
        T, assign, n_inl, visible, found = track_one(T_pred, frame)
        ok = n_inl >= 25
        padded = n_valid_frames <= w          # duplicated tail padding
        active = (~stopped) & ok & (~padded)
        need_kf, dec_next = kf_decision(T, n_inl, ts, frame, assign, dec)
        need_kf = need_kf & active
        new_dec = torch.where(active, dec_next, dec)
        new_vel = torch.where(
            active, lie.orthonormalize(T @ lie.se3_inverse(T_last_c)), vel)
        new_T = torch.where(active, T, T_last_c)
        stop_after = stopped | ((~ok) & (~padded))
        outs.append(torch.cat([
            T.reshape(-1),
            torch.stack([n_inl.float(), ok.float(), need_kf.float(),
                         stopped.float()]),
            pad_row,
        ]))
        vis_sum = vis_sum + torch.where(active, visible, 0.0)
        fnd_sum = fnd_sum + torch.where(active, found, 0.0)
        assigns.append(torch.where(active, assign, -1).to(torch.int16))
        T_last_c, vel, dec, stopped = new_T, new_vel, new_dec, stop_after
    return (torch.stack(outs), torch.stack(assigns),
            vis_sum.to(torch.int32), fnd_sum.to(torch.int32),
            (T_last_c, vel, dec, stopped))


window_track = graphs.compiled(
    _window_track, static=("n_slots", "two_stage", "use_imu"),
    name="window_track")
