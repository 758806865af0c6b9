"""ORB from pixels in plain PyTorch: pyramid, FAST-16, NMS, orientation,
rotated BRIEF.

The reference for the ORB features the TUM cell's front-end produces: the
algorithm and constants of ``snakeslam_tpu_torch/ops/orb.py``'s plain path
and ``ops/orb_kernels.py``'s plain FAST, written out here without the
graph layer or the hand-written kernels (the program's FAST kernel and its
plain version agree bit for bit, so the reference's features are the
program's exactly).  ``dtype`` is the precision the image arithmetic runs
in: float32 as the configuration states, or a lower one for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FAST_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)  # (dx, dy), clockwise from 12 o'clock
PATCH_R = 15
DESC_BITS = 256
_PATCH = 2 * PATCH_R + 1
_disc_y, _disc_x = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
_DISC_MASK = (_disc_x**2 + _disc_y**2 <= PATCH_R**2).astype(np.float32)
_BRIEF_BINS = 30
_BRIEF_PATCH = 40
_BRIEF_SRC = _BRIEF_PATCH + 6
_CENTER_OFF = (_BRIEF_SRC - _PATCH) // 2


def _brief_pattern(seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(scale=PATCH_R / 2.3, size=(DESC_BITS, 2, 2)),
                  -(PATCH_R - 2), PATCH_R - 2)
    return pts.astype(np.float32)


def _brief_offsets() -> np.ndarray:
    pattern = _brief_pattern()
    half = _BRIEF_PATCH // 2
    out = np.empty((_BRIEF_BINS, 2 * DESC_BITS), dtype=np.int64)
    for b in range(_BRIEF_BINS):
        a = np.radians(b * 360.0 / _BRIEF_BINS)
        c, s = np.cos(a), np.sin(a)
        px, py = pattern[:, :, 0], pattern[:, :, 1]
        ix = np.round(c * px - s * py).astype(np.int32) + half
        iy = np.round(s * px + c * py).astype(np.int32) + half
        lin = iy * _BRIEF_PATCH + ix
        out[b] = np.concatenate([lin[:, 0], lin[:, 1]])
    return out


_OFFSETS = _brief_offsets()


def _arc9(bits: torch.Tensor) -> torch.Tensor:
    m = bits | (bits << 16)
    acc = m
    for k in range(1, 9):
        acc = acc & (m >> k)
    return (acc & 0xFFFF) != 0


def fast_score(imgs: torch.Tensor, threshold: float):
    """(B, H, W) -> FAST-16 scores, borders (3 px) zeroed; the ring summed
    in order k = 0..15."""
    B, H, W = imgs.shape
    i32 = torch.int32
    th = torch.tensor(threshold, dtype=imgs.dtype)
    bits_b = torch.zeros(imgs.shape, dtype=i32)
    bits_d = torch.zeros_like(bits_b)
    sum_b = torch.zeros_like(imgs)
    sum_d = torch.zeros_like(imgs)
    zero = torch.zeros((), dtype=imgs.dtype)
    for k, (dx, dy) in enumerate(FAST_RING):
        ring = torch.roll(imgs, shifts=(-int(dy), -int(dx)), dims=(1, 2))
        bright = ring > imgs + th
        dark = ring < imgs - th
        bits_b = bits_b | (bright.to(i32) << k)
        bits_d = bits_d | (dark.to(i32) << k)
        sum_b = sum_b + torch.where(bright, ring - imgs - th, zero)
        sum_d = sum_d + torch.where(dark, imgs - ring - th, zero)
    yy = torch.arange(H)[:, None]
    xx = torch.arange(W)[None, :]
    border = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    corner = (_arc9(bits_b) | _arc9(bits_d)) & border
    return torch.where(corner, torch.maximum(sum_b, sum_d), zero)


def nms3(score: torch.Tensor) -> torch.Tensor:
    H, W = score.shape[-2:]
    m = F.max_pool2d(score.float().reshape(-1, 1, H, W), 3, stride=1,
                     padding=1).reshape(score.shape).to(score.dtype)
    return torch.where((score >= m) & (score > 0), score,
                       torch.zeros_like(score))


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, n: int, cell: int = 32,
                     per_cell: int = 4):
    """Top ``per_cell`` responses of each cell, then the global top ``n``."""
    B, H, W = score.shape
    Hc, Wc = -(-H // cell), -(-W // cell)
    s = F.pad(score, (0, Wc * cell - W, 0, Hc * cell - H))
    b = s.reshape(B, Hc, cell, Wc, cell).permute(0, 1, 3, 2, 4).reshape(
        B, Hc * Wc, cell * cell)
    col = torch.arange(cell * cell)
    neg_inf = torch.full((), -math.inf, dtype=b.dtype)
    vals_l, idx_l = [], []
    for _ in range(per_cell):
        i = torch.argmax(b, dim=2)
        vals_l.append(torch.gather(b, 2, i[..., None])[..., 0])
        idx_l.append(i)
        b = torch.where(col == i[..., None], neg_inf, b)
    vals = torch.stack(vals_l, 2)
    idx = torch.stack(idx_l, 2)
    cells = torch.arange(Hc * Wc)
    py = idx // cell + ((cells // Wc) * cell)[:, None]
    px = idx % cell + ((cells % Wc) * cell)[:, None]
    flat_vals = vals.reshape(B, -1)
    take = min(n, flat_vals.shape[1])
    top_vals, top_i = _top_k(flat_vals, take)
    uv = torch.stack([torch.gather(px.reshape(B, -1), 1, top_i).float(),
                      torch.gather(py.reshape(B, -1), 1, top_i).float()], -1)
    valid = top_vals > 0
    if take < n:
        uv = F.pad(uv, (0, 0, 0, n - take))
        top_vals = F.pad(top_vals, (0, n - take))
        valid = F.pad(valid, (0, n - take))
    return uv, top_vals, valid


def _taps(n_out: int, n_in: int):
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    w = np.clip(x - x0, 0.0, 1.0)
    m = np.zeros((n_out, n_in), dtype=np.float32)
    m[np.arange(n_out), x0] += 1.0 - w
    m[np.arange(n_out), x1] += w
    nz = m != 0
    c0 = nz.argmax(axis=1)
    c1 = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    rows = np.arange(n_out)
    w0 = m[rows, c0]
    w1 = np.where(c1 != c0, m[rows, c1], 0.0).astype(np.float32)
    return c0, c1, w0, w1


def resize_bilinear(imgs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear downscale with half-pixel centres, rows then columns, each
    output ``x[c0] * w0 + x[c1] * w1``."""
    def along(x, dim, n_out):
        c0, c1, w0, w1 = _taps(n_out, x.shape[dim])
        shape = [1, 1, 1]
        shape[dim] = n_out
        return (x.index_select(dim, torch.from_numpy(c0))
                * torch.from_numpy(w0).to(x.dtype).view(shape)
                + x.index_select(dim, torch.from_numpy(c1))
                * torch.from_numpy(w1).to(x.dtype).view(shape))
    return along(along(imgs, 1, h), 2, w)


def _patches(imgs: torch.Tensor, uv: torch.Tensor, size: int):
    half = size // 2
    B, H, W = imgs.shape
    y0 = torch.clamp(uv[..., 1].to(torch.int32) - half, 0, H - size)
    x0 = torch.clamp(uv[..., 0].to(torch.int32) - half, 0, W - size)
    ar = torch.arange(size)
    rows = (y0[..., None].long() + ar) * W
    cols = x0[..., None].long() + ar
    flat = (rows[..., :, None] + cols[..., None, :]).reshape(B, -1)
    return torch.gather(imgs.reshape(B, H * W), 1, flat).reshape(
        B, uv.shape[1], size, size)


def _box_blur(p: torch.Tensor, k: int = 7) -> torch.Tensor:
    o = p.shape[-1] - k + 1
    scale = float(np.float32(1.0 / k))
    out = sum(p[..., i:i + o, :] for i in range(k)) * scale
    return sum(out[..., :, i:i + o] for i in range(k)) * scale


def orient_and_brief(imgs: torch.Tensor, uv: torch.Tensor):
    """Intensity-centroid angle (degrees; moments in float64) and rotated
    BRIEF bits from one 46x46 patch per keypoint."""
    B, H, W = imgs.shape
    if H < _BRIEF_SRC or W < _BRIEF_SRC:
        imgs = F.pad(imgs, (0, max(0, _BRIEF_SRC - W),
                            0, max(0, _BRIEF_SRC - H)))
    src = _patches(imgs, uv, _BRIEF_SRC)
    center = src[..., _CENTER_OFF:_CENTER_OFF + _PATCH,
                 _CENTER_OFF:_CENTER_OFF + _PATCH]
    wx = torch.from_numpy((_disc_x * _DISC_MASK).astype(np.float64))
    wy = torch.from_numpy((_disc_y * _DISC_MASK).astype(np.float64))
    m10 = torch.einsum("bnij,ij->bn", center.double(), wx)
    m01 = torch.einsum("bnij,ij->bn", center.double(), wy)
    ang = (torch.atan2(m01, m10) * (180.0 / math.pi)).float()
    ang = torch.where(ang < 0, ang + 360.0, ang)
    blur = _box_blur(src).reshape(B, uv.shape[1], -1)
    b = torch.remainder(torch.round(ang * (_BRIEF_BINS / 360.0)).to(
        torch.int32), _BRIEF_BINS)
    samples = torch.gather(blur, -1, torch.from_numpy(_OFFSETS)[b.long()])
    bits = (samples[..., :DESC_BITS] < samples[..., DESC_BITS:]).to(
        torch.uint8)
    return ang, bits


def extract(image: np.ndarray, n_features: int, levels: int,
            scale_factor: float, threshold: float, dtype=torch.float32):
    """ORB of one (H, W) image in [0, 255]: (uv (n, 2) float64 level-0
    pixels, octave (n,), angle (n,), descriptors (n, 32) packed uint8) of
    the valid slots, strongest first."""
    images = torch.from_numpy(np.asarray(image, dtype=np.float32))[None]
    images = images.to(dtype)
    B, H, W = images.shape
    inv = [scale_factor ** (-i) for i in range(levels)]
    total = sum(inv)
    budgets = [max(int(round(n_features * v / total)), 8) for v in inv]
    budgets[0] += n_features - sum(budgets)
    feats = []
    lvl_imgs = images
    for lvl in range(levels):
        scale = scale_factor ** lvl
        if lvl > 0:
            lvl_imgs = resize_bilinear(images, int(round(H / scale)),
                                       int(round(W / scale)))
        score = nms3(fast_score(lvl_imgs, threshold))
        uv, resp, valid = select_keypoints(score, budgets[lvl])
        ang, bits = orient_and_brief(lvl_imgs, uv)
        feats.append((uv * scale, resp.float(),
                      torch.full(uv.shape[:2], lvl, dtype=torch.int32), ang,
                      bits, valid))
    uv, resp, octv, ang, bits, valid = (torch.cat([f[k] for f in feats], 1)
                                        for k in range(6))
    key = torch.where(valid, resp, torch.full_like(resp, -1.0))
    _, idx = _top_k(key, n_features)

    def take(x):
        i = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, i.expand((-1, -1) + x.shape[2:]))[0]

    uv, octv, ang, bits, valid = (take(x) for x in (uv, octv, ang, bits,
                                                     valid))
    v = valid.numpy()
    desc = np.packbits(bits.numpy()[v], axis=-1, bitorder="little")
    return (uv.numpy()[v].astype(np.float64), octv.numpy()[v],
            ang.numpy()[v], desc)


def mismatch_pct(ref, prog) -> float:
    """The share, in %, of the reference's features that the program's
    set does not hold exactly (pixel, octave, angle and all 256 bits),
    with the program's surplus features counted as misses too."""
    def rows(f):
        uv, octv, ang, desc = f
        return {(float(uv[i, 0]), float(uv[i, 1]), int(octv[i]),
                 float(ang[i]), bytes(desc[i])) for i in range(len(uv))}
    a, b = rows(ref), rows(prog)
    n = max(len(a), 1)
    return 100.0 * (len(a - b) + len(b - a)) / n
