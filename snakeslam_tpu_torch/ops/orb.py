"""ORB feature extraction on tensors: pyramid, FAST, NMS, orientation, rBRIEF.

Counterpart of ``snakeslam_tpu/ops/orb.py``, with the JAX package's ``vmap``
over images written out as a leading batch dimension.  The design is the
same data-parallel one: FAST-16 as bit arithmetic over whole images, a 3x3
max-pool NMS, per-cell top-k then a global top-N, intensity-centroid
orientation and rotated BRIEF from one 46x46 patch pull per keypoint.

FAST runs through ``ops/orb_kernels.fast_score_batch``: CUDA tensors launch
the hand-written kernel (``csrc/fast_score.cu``), CPU tensors take its plain
version.  The constants below are copied verbatim from the JAX package, so
both packages sample the same ring, disc and BRIEF pattern.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values.  Here
every top-k is a stable descending sort, which does the same; ``argmax`` /
``argmin`` already return the first occurrence on CPU and CUDA.

On the card ``extract_orb`` and ``extract_orb_batch`` are compiled programs
(``utils/graphs.py``), as the JAX package jits them: one captured CUDA
graph per image shape and static settings (``n_features``, ``levels``,
``scale_factor``, ``threshold``), with the FAST kernel's launches (one a
pyramid level) inside it.  Their tables (resize taps, the disc weights,
the BRIEF offsets) are device constants made on the first, eager call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from snakeslam_tpu_torch.utils import graphs

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12 o'clock
FAST_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)  # (dx, dy)

PATCH_R = 15          # orientation disc radius (ORB HALF_PATCH_SIZE)
DESC_BITS = 256


def fast_score(img: torch.Tensor, threshold: float):
    """FAST-16 segment test + SAD score of one (H, W) float32 image, the
    plain version.  Returns (score (H, W) float32, is_corner (H, W) bool);
    borders (3 px) are zeroed."""
    from snakeslam_tpu_torch.ops.orb_kernels import fast_score_batch_reference

    score, corner = fast_score_batch_reference(img[None], threshold)
    return score[0], corner[0]


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression over the last two dims (-inf padding,
    the ``reduce_window`` 'SAME' of the JAX package)."""
    H, W = score.shape[-2:]
    m = F.max_pool2d(score.reshape(-1, 1, H, W), 3, stride=1,
                     padding=1).reshape(score.shape)
    return torch.where((score >= m) & (score > 0), score,
                       torch.zeros_like(score))


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: the lower index first among
    equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, n_keypoints: int, cell: int = 32,
                     per_cell: int = 4):
    """Spatially distributed top-N selection.

    Top-``per_cell`` responses per (cell x cell) block, then global top-N.
    ``score`` is (H, W) or (B, H, W).  Returns (uv (..., N, 2) float32
    level coords, resp (..., N), valid (..., N))."""
    if score.dim() == 2:
        return tuple(t[0] for t in select_keypoints(score[None], n_keypoints,
                                                    cell, per_cell))
    B, H, W = score.shape
    dev = score.device
    Hc = -(-H // cell)
    Wc = -(-W // cell)
    s = F.pad(score, (0, Wc * cell - W, 0, Hc * cell - H))
    blocks = s.reshape(B, Hc, cell, Wc, cell).permute(0, 1, 3, 2, 4).reshape(
        B, Hc * Wc, cell * cell)
    # per-cell top-k as `per_cell` argmax+suppress rounds (the JAX
    # package's choice; argmax takes the first of equal values)
    vals_l, idx_l = [], []
    b = blocks
    col = torch.arange(cell * cell, device=dev)
    neg_inf = torch.full((), -math.inf, dtype=b.dtype, device=dev)
    for _ in range(per_cell):
        i = torch.argmax(b, dim=2)
        vals_l.append(torch.gather(b, 2, i[..., None])[..., 0])
        idx_l.append(i)
        b = torch.where(col == i[..., None], neg_inf, b)
    vals = torch.stack(vals_l, dim=2)                # (B, Hc*Wc, per_cell)
    idx = torch.stack(idx_l, dim=2)
    cells = torch.arange(Hc * Wc, device=dev)
    py = idx // cell + ((cells // Wc) * cell)[:, None]
    px = idx % cell + ((cells % Wc) * cell)[:, None]
    flat_vals = vals.reshape(B, -1)
    flat_y = py.reshape(B, -1)
    flat_x = px.reshape(B, -1)
    take = min(n_keypoints, flat_vals.shape[1])
    top_vals, top_i = _top_k(flat_vals, take)
    uv = torch.stack([torch.gather(flat_x, 1, top_i).to(torch.float32),
                      torch.gather(flat_y, 1, top_i).to(torch.float32)],
                     dim=-1)
    valid = top_vals > 0
    if take < n_keypoints:
        pad = n_keypoints - take
        uv = F.pad(uv, (0, 0, 0, pad))
        top_vals = F.pad(top_vals, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, top_vals, valid


# ---------------------------------------------------------------------------
# per-keypoint patch work: orientation + descriptors
# ---------------------------------------------------------------------------

_PATCH = 2 * PATCH_R + 1
_disc_y, _disc_x = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
_DISC_MASK = (_disc_x**2 + _disc_y**2 <= PATCH_R**2).astype(np.float32)


def _extract_patches(imgs: torch.Tensor, uv: torch.Tensor, size: int):
    """(B, H, W) images, (B, N, 2) keypoints -> (B, N, size, size) patches
    centred at uv (clamped to the image), as one flat gather."""
    half = size // 2
    B, H, W = imgs.shape
    y0 = torch.clamp(uv[..., 1].to(torch.int32) - half, 0, H - size)
    x0 = torch.clamp(uv[..., 0].to(torch.int32) - half, 0, W - size)
    ar = torch.arange(size, device=imgs.device)
    rows = (y0[..., None].long() + ar) * W                 # (B, N, size)
    cols = x0[..., None].long() + ar
    flat = (rows[..., :, None] + cols[..., None, :]).reshape(B, -1)
    return torch.gather(imgs.reshape(B, H * W), 1, flat).reshape(
        B, uv.shape[1], size, size)


def _make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """256 point pairs, Gaussian-distributed in the 31x31 patch."""
    rng = np.random.default_rng(seed)
    pts = np.clip(
        rng.normal(scale=PATCH_R / 2.3, size=(DESC_BITS, 2, 2)),
        -(PATCH_R - 2), PATCH_R - 2,
    )
    return pts.astype(np.float32)  # (256, 2 endpoints, 2 coords (x, y))


BRIEF_PATTERN = _make_brief_pattern()


_INTERP_CACHE: dict = {}


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, half-pixel centers
    (the sampling convention of jax.image.resize 'linear')."""
    key = (n_out, n_in)
    m = _INTERP_CACHE.get(key)
    if m is None:
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
        x1 = np.clip(x0 + 1, 0, n_in - 1)
        w = np.clip(x - x0, 0.0, 1.0)
        m = np.zeros((n_out, n_in), dtype=np.float32)
        m[np.arange(n_out), x0] += 1.0 - w
        m[np.arange(n_out), x1] += w
        _INTERP_CACHE[key] = m
    return m


_TAP_CACHE: dict = {}


def _interp_taps(n_out: int, n_in: int):
    """The two taps of each row of ``_interp_matrix(n_out, n_in)``: (first
    column, last column, their weights); a row with one non-zero (the
    clamped border) has its whole weight on the first tap."""
    key = (n_out, n_in)
    t = _TAP_CACHE.get(key)
    if t is None:
        m = _interp_matrix(n_out, n_in)
        nz = m != 0
        c0 = nz.argmax(axis=1)
        c1 = n_in - 1 - nz[:, ::-1].argmax(axis=1)
        rows = np.arange(n_out)
        w0 = m[rows, c0]
        w1 = np.where(c1 != c0, m[rows, c1], 0.0).astype(np.float32)
        t = _TAP_CACHE[key] = (c0, c1, w0, w1)
    return t


def _resize_bilinear(imgs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) -> (B, h, w) bilinear downscale: rows, then columns, each
    output ``x[c0] * w0 + x[c1] * w1`` over ``_interp_matrix``'s two taps
    (the JAX package multiplies by the whole matrices; the values agree to
    the last ulps).  Two products and one sum, each rounded on its own, so
    the CPU and a CUDA device give the same bits: a matrix product sums
    (and fuses multiply-adds) in an order of its library's choosing."""
    def along(x, dim, n_out):
        n_in = x.shape[dim]
        c0, c1, w0, w1 = (
            graphs.constant(("orb_taps", n_out, n_in, k), x.device,
                            lambda k=k: _interp_taps(n_out, n_in)[k])
            for k in range(4))
        shape = [1, 1, 1]
        shape[dim] = n_out
        return (x.index_select(dim, c0) * w0.view(shape)
                + x.index_select(dim, c1) * w1.view(shape))

    return along(along(imgs, 1, h), 2, w)


def box_blur_batch(imgs: torch.Tensor, k: int = 7) -> torch.Tensor:
    """(B, H, W) k x k box filter (separable shift-and-add, zero padding)
    — the BRIEF pre-smoothing, summed in the JAX package's order."""
    r = k // 2
    scale = float(np.float32(1.0 / k))
    H, W = imgs.shape[1:]
    p = F.pad(imgs, (0, 0, r, r))
    out = sum(p[:, i:i + H, :] for i in range(k)) * scale
    p = F.pad(out, (r, r))
    return sum(p[:, :, i:i + W] for i in range(k)) * scale


# rBRIEF angle quantization: 30 bins of 12 deg (the ORB recipe), which lets
# the rotated sample positions be precomputed per bin as patch offsets.
_BRIEF_BINS = 30
_BRIEF_PATCH = 40          # rotated samples reach |13*sqrt(2)| ~ 18.4 px


def _make_brief_offsets() -> np.ndarray:
    """(30, 512) static flat offsets into a 40x40 patch, one row per
    quantized angle; columns are [endpoint0 x256, endpoint1 x256]."""
    half = _BRIEF_PATCH // 2
    out = np.empty((_BRIEF_BINS, 2 * DESC_BITS), dtype=np.int32)
    for b in range(_BRIEF_BINS):
        a = np.radians(b * 360.0 / _BRIEF_BINS)
        c, s = np.cos(a), np.sin(a)
        px = BRIEF_PATTERN[:, :, 0]
        py = BRIEF_PATTERN[:, :, 1]
        ix = np.round(c * px - s * py).astype(np.int32) + half
        iy = np.round(s * px + c * py).astype(np.int32) + half
        lin = iy * _BRIEF_PATCH + ix                 # (256, 2)
        out[b] = np.concatenate([lin[:, 0], lin[:, 1]])
    return out


_BRIEF_OFFSETS = _make_brief_offsets()


def _brief_from_patches(patches: torch.Tensor, angle_deg: torch.Tensor):
    """(..., N, 1600) flattened blurred 40x40 patches + angles -> (..., N,
    256) int8 bits.  The JAX package's 30 masked takes, one per bin, are a
    single gather of each keypoint's own bin row here (same samples)."""
    bin_ = torch.round(angle_deg * (_BRIEF_BINS / 360.0)).to(torch.int32)
    bin_ = torch.remainder(bin_, _BRIEF_BINS)
    offsets = graphs.constant("orb_brief_offsets", patches.device,
                              lambda: _BRIEF_OFFSETS.astype(np.int64))
    samples = torch.gather(patches, -1, offsets[bin_.long()])
    return (samples[..., :DESC_BITS] < samples[..., DESC_BITS:]).to(
        torch.int8)


# fused patch pipeline: one 46x46 pull per keypoint feeds orientation,
# BRIEF pre-smoothing, and the rotated BRIEF samples
_BRIEF_SRC = _BRIEF_PATCH + 6           # 7x7 box-blur halo (r=3 each side)
_CENTER_OFF = (_BRIEF_SRC - _PATCH) // 2   # 31x31 orientation disc offset


def _box_blur_patches(p: torch.Tensor, k: int = 7) -> torch.Tensor:
    """(..., S, S) -> (..., S-k+1, S-k+1) valid-region box blur (separable
    shift-and-add in the JAX package's order)."""
    s = p.shape[-1]
    o = s - k + 1
    scale = float(np.float32(1.0 / k))
    out = sum(p[..., i:i + o, :] for i in range(k)) * scale
    return sum(out[..., :, i:i + o] for i in range(k)) * scale


def orient_and_brief(imgs: torch.Tensor, uv: torch.Tensor):
    """Orientation (degrees) and rotated BRIEF bits from one 46x46 patch
    pull per keypoint.  ``imgs`` (B, H, W) float32, ``uv`` (B, N, 2) level
    coords; returns (angle (B, N), bits (B, N, 256) int8).

    The patch's centre 31x31 disc gives the intensity centroid (IC_Angle);
    its 7x7 box blur gives the 40x40 window the BRIEF samples read."""
    B, H, W = imgs.shape
    if H < _BRIEF_SRC or W < _BRIEF_SRC:
        imgs = F.pad(imgs, (0, max(0, _BRIEF_SRC - W),
                            0, max(0, _BRIEF_SRC - H)))
    src = _extract_patches(imgs, uv, _BRIEF_SRC)          # (B, N, 46, 46)
    center = src[..., _CENTER_OFF:_CENTER_OFF + _PATCH,
                 _CENTER_OFF:_CENTER_OFF + _PATCH]        # (B, N, 31, 31)
    wx = graphs.constant("orb_disc_wx", imgs.device,
                         lambda: (_disc_x * _DISC_MASK).astype(np.float32))
    wy = graphs.constant("orb_disc_wy", imgs.device,
                         lambda: (_disc_y * _DISC_MASK).astype(np.float32))
    # the moments in float64: a float32 pixel times an integer weight is
    # exact there, and the disc's sums are exact or an ulp of float64 apart
    # whatever the order, so the CPU and a CUDA device round them to the
    # same float32 angle (in float32 a resized level's sums round by
    # summation order, and a BRIEF bin or the angle itself can differ)
    m10 = torch.einsum("bnij,ij->bn", center.double(), wx.double())
    m01 = torch.einsum("bnij,ij->bn", center.double(), wy.double())
    # jnp.degrees is a multiply by 180/pi
    ang = (torch.atan2(m01, m10) * (180.0 / math.pi)).float()
    ang = torch.where(ang < 0, ang + 360.0, ang)
    blur = _box_blur_patches(src)                         # (B, N, 40, 40)
    bits = _brief_from_patches(
        blur.reshape(B, uv.shape[1], _BRIEF_PATCH * _BRIEF_PATCH), ang)
    return ang, bits


# ---------------------------------------------------------------------------
# the full extractor
# ---------------------------------------------------------------------------

class OrbFeatures(NamedTuple):
    uv: torch.Tensor        # (N, 2) level-0 pixel coords
    response: torch.Tensor  # (N,)
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) degrees
    desc_bits: torch.Tensor  # (N, 256) int8
    valid: torch.Tensor     # (N,) bool


def _extract_orb(image: torch.Tensor, n_features: int = 1000,
                 levels: int = 4, scale_factor: float = 1.2,
                 threshold: float = 20.0):
    """Full ORB pipeline over an image pyramid of one (H, W) float32 image
    in [0, 255].  Returns OrbFeatures with n_features slots (coords in
    level-0 pixels)."""
    out = _extract_orb_batch(image[None], n_features, levels, scale_factor,
                             threshold)
    return OrbFeatures(*[x[0] for x in out])


def _extract_orb_batch(images: torch.Tensor, n_features: int = 1000,
                       levels: int = 4, scale_factor: float = 1.2,
                       threshold: float = 20.0) -> OrbFeatures:
    """Batched ORB: (B, H, W) float32 images -> OrbFeatures with leading B.

    One FAST launch per pyramid level covers the whole batch (CUDA tensors:
    the kernel; CPU tensors: its plain version); every other stage is
    batched tensor code."""
    from snakeslam_tpu_torch.ops.orb_kernels import fast_score_batch

    B, H, W = images.shape
    # per-level feature budget ~ geometric (like the reference's
    # distribution over octaves)
    inv = [scale_factor ** (-i) for i in range(levels)]
    total = sum(inv)
    budgets = [max(int(round(n_features * v / total)), 8) for v in inv]
    budgets[0] += n_features - sum(budgets)

    all_feats = []
    imgs_l = images
    for lvl in range(levels):
        scale = scale_factor**lvl
        if lvl > 0:
            h = int(round(H / scale))
            w = int(round(W / scale))
            imgs_l = _resize_bilinear(images, h, w)
        score, _ = fast_score_batch(imgs_l, threshold)
        score = nms3(score)
        uv, resp, valid = select_keypoints(score, budgets[lvl])
        ang, bits = orient_and_brief(imgs_l, uv)
        all_feats.append(
            (uv * scale, resp,
             torch.full(uv.shape[:2], lvl, dtype=torch.int32,
                        device=images.device), ang, bits, valid))

    uv, resp, octv, ang, bits, valid = (
        torch.cat([f[k] for f in all_feats], dim=1) for k in range(6))

    # compact to exactly n_features slots per frame, strongest first
    order_key = torch.where(valid, resp, torch.full_like(resp, -1.0))
    _, idx = _top_k(order_key, n_features)                 # (B, n_features)

    def take(x):
        i = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, i.expand((-1, -1) + x.shape[2:]))

    return OrbFeatures(uv=take(uv), response=take(resp), octave=take(octv),
                       angle=take(ang), desc_bits=take(bits),
                       valid=take(valid))


_ORB_STATIC = ("n_features", "levels", "scale_factor", "threshold")
extract_orb = graphs.compiled(_extract_orb, static=_ORB_STATIC,
                              name="orb")
extract_orb_batch = graphs.compiled(_extract_orb_batch, static=_ORB_STATIC,
                                    name="orb_batch")
