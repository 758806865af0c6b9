"""Peaks of the card and the hand-written kernels' operations and bytes.

A frozen copy of ``chip_smoke.py``'s roofline arithmetic (``bound``,
``pose_bound``, ``fast_bound`` and their constants), so that a change to
the program's own copy cannot move the yardstick.  The least time a launch
could take is the larger of its bytes at the HBM rate and its float32
operations at the rate outside the tensor cores; a roofline share is that
least time over the launch's measured device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM's published peaks (data sheet, dense): HBM3 bytes/s and
# float32 operations/s outside the tensor cores, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations of the pose refine, counted from its plain version: per
# feature and GN step the residual (~37), Huber weight (5), Jacobian rows
# (~47) and the 27 weighted normal-equation terms (189); per feature and
# chi2 reclassification the residual alone
POSE_OPS_PER_FEATURE_STEP = 278
POSE_OPS_PER_FEATURE_RECLASS = 38

# f32 operations of FAST per pixel: the compass test of the four ring
# pixels (2 threshold adds, 8 compares) for every pixel; the full 16-pixel
# test (2 compares, 3 subtractions and 2 adds per ring pixel, the max) for
# the pixels that pass it
FAST_OPS_COMPASS = 10
FAST_OPS_FULL = 16 * 7 + 1


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in seconds, and which of the two bounds sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pose_bound_s(n: int, outer: int, inner: int,
                 batch: int = 1) -> tuple[float, str]:
    """The pose refine's least time for ``batch`` stereo problems of ``n``
    feature slots under ``outer`` x ``inner`` GN steps: T_init, points,
    uv, right, weight, mask and the five camera scalars read once, the
    poses, inlier flags and counts written once."""
    nbytes = batch * (64 + n * (12 + 8 + 4 + 4 + 1) + 64 + n + 4) + 5 * 4
    ops = batch * n * (POSE_OPS_PER_FEATURE_STEP * outer * inner
                       + POSE_OPS_PER_FEATURE_RECLASS * outer)
    return bound_s(nbytes, ops)


def fast_bound_s(n_pixels: int, n_pass: int) -> tuple[float, str]:
    """FAST's least time on ``n_pixels`` of which ``n_pass`` pass the
    compass test: 4 bytes read and 5 written per pixel (score and corner
    flag), the compass test on every pixel and the full test on those that
    pass it."""
    return bound_s(9 * n_pixels,
                   FAST_OPS_COMPASS * n_pixels + FAST_OPS_FULL * n_pass)


def fast_bound_any_s(n_pixels: int) -> float:
    """FAST's least time whatever the image: with every pixel passing the
    compass test its operations take 123 / 67e12 s a pixel, under the
    9 / 3.35e12 s of its bytes, so the bytes set the bound on any input."""
    t, by = fast_bound_s(n_pixels, n_pixels)
    if by != "bytes":
        raise ValueError("FAST's operations bound it: recount its bound")
    return t
