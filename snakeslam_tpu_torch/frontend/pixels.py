"""Pixels-in batched stereo front-end: one pass over a chunk of stereo pairs.

Counterpart of ``snakeslam_tpu/frontend/pixels.py``.  A chunk of stereo
pairs goes through ORB extraction with left and right stacked into one
batch (one FAST launch per pyramid level for both views), dense masked
stereo matching (the gates of the reference's Preprocess.cpp:122-242 as one
batched Hamming matrix product), and descriptor packing, all on the
device.

``StereoPixelSource`` drives it chunk-ahead: uint8 images go up from pinned
host memory with non-blocking copies and are cast on the device; results
come back by non-blocking copies into pinned host tensors followed by a
recorded CUDA event, which ``materialize`` waits on.  So the host converts
chunk k while the device works on chunk k+1, and extraction chunks queue
on the device stream between the tracking windows.  On the card
``stereo_frontend_batch`` is a compiled program (``utils/graphs.py``), as
the JAX package jits it whole: one captured CUDA graph a chunk shape, the
FAST kernel's launches inside it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.ops.descriptors import hamming_matrix
from snakeslam_tpu_torch.ops.orb import OrbFeatures, _extract_orb_batch
from snakeslam_tpu_torch.utils import graphs


def _pack_bits_dev(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 32) uint8, bitorder='little' (matches
    ops/descriptors.pack_bits_np / unpack_bits)."""
    i32, dev = torch.int32, bits.device
    w = torch.ones(8, dtype=i32, device=dev) << torch.arange(
        8, dtype=i32, device=dev)
    b = bits.reshape(bits.shape[:-1] + (32, 8)).to(torch.int32)
    return (b * w).sum(dim=-1).to(torch.uint8)


def _stereo_gates(uv_l, oct_l, bits_l, val_l, uv_r, oct_r, bits_r, val_r,
                  bf, row_tol, max_disp, max_hamming=60):
    """Dense masked stereo matching for a batch of frames (leading dims),
    the gates of Preprocess.cpp:122-242 as masks over full Hamming
    matrices.  Returns (right_u, depth) per left slot; -1 where unmatched.
    The first of equal distances wins (``argmin``), as in the JAX package.
    """
    H = hamming_matrix(bits_l, bits_r)                       # (..., N, M)
    du_row = torch.abs(uv_l[..., :, None, 1] - uv_r[..., None, :, 1])
    disparity = uv_l[..., :, None, 0] - uv_r[..., None, :, 0]
    oct_ok = torch.abs(oct_l[..., :, None] - oct_r[..., None, :]) <= 1
    cand = ((du_row <= row_tol) & (disparity > 0.1) & (disparity < max_disp)
            & oct_ok & (H <= max_hamming)
            & val_l[..., :, None] & val_r[..., None, :])
    Hm = torch.where(cand, H, torch.full_like(H, 999))
    best_j = torch.argmin(Hm, dim=-1)
    best = torch.gather(Hm, -1, best_j[..., None])[..., 0]
    matched = best <= max_hamming
    ur = torch.gather(uv_r[..., 0], -1, best_j)
    disp = uv_l[..., 0] - ur
    neg = torch.full_like(disp, -1.0)
    z = torch.where(matched & (disp > 0.1), bf / torch.clamp(disp, min=0.1),
                    neg)
    right = torch.where(z > 0, ur, neg)
    depth = torch.where(z > 0, z, neg)
    return right, depth


def _stereo_frontend_batch(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                           bf: float, n_features: int = 1000,
                           levels: int = 4, scale_factor: float = 1.2,
                           threshold: float = 20.0, relaxed: bool = False):
    """(B, H, W) stereo pairs (any real dtype, cast to float32 on their
    device) -> per-frame features + stereo depth.

    Returns (uv, octave, angle, packed_desc, valid, right, depth), all with
    leading B and n_features slots, on the images' device.  As the
    compiled ``stereo_frontend_batch`` every argument but the images is
    static (``bf`` a Python float, fixed by the settings); the outputs are
    the graph's buffers until its next call.
    """
    B = imgs_l.shape[0]
    f = _extract_orb_batch(
        torch.cat([imgs_l, imgs_r], dim=0).to(torch.float32),
        n_features=n_features, levels=levels, scale_factor=scale_factor,
        threshold=threshold)
    fl = OrbFeatures(*(x[:B] for x in f))
    fr = OrbFeatures(*(x[B:] for x in f))
    row_tol = 2.0 * (2.0 if relaxed else 1.0)
    bf = torch.full((), bf, dtype=torch.float32, device=imgs_l.device)
    max_disp = torch.where(bf > 0, bf / 0.3,
                           torch.full_like(bf, 200.0))       # z >= 0.3 m
    right, depth = _stereo_gates(fl.uv, fl.octave, fl.desc_bits, fl.valid,
                                 fr.uv, fr.octave, fr.desc_bits, fr.valid,
                                 bf, row_tol, max_disp)
    packed = _pack_bits_dev(fl.desc_bits)
    return fl.uv, fl.octave, fl.angle, packed, fl.valid, right, depth


stereo_frontend_batch = graphs.compiled(
    _stereo_frontend_batch,
    static=("bf", "n_features", "levels", "scale_factor", "threshold",
            "relaxed"),
    name="stereo_frontend")


@dataclass
class _Chunk:
    """One dispatched chunk: the host tensors its results are copied into,
    the event recorded behind those copies, and the pinned sources of its
    uploads (referenced until the chunk is materialized)."""
    host: tuple
    event: object = None
    uploads: tuple = ()


class StereoPixelSource:
    """Chunk-ahead pixel front-end on ``device``.

    ``dispatch`` queues one chunk's extraction and starts the D2H copies;
    ``materialize`` waits for them and builds FrameData.  Callers overlap:
    dispatch chunk k+1 before materializing chunk k.
    """

    def __init__(self, settings, device):
        self.s = settings
        self.device = torch.device(device)

    def _upload(self, imgs: np.ndarray):
        """Ship the caller's dtype (uint8 costs a quarter of float32's
        bytes); the front-end casts on the device."""
        host = torch.from_numpy(np.ascontiguousarray(imgs))
        if self.device.type != "cuda":
            return host.to(self.device), None
        host = host.pin_memory()
        return host.to(self.device, non_blocking=True), host

    def dispatch(self, imgs_l: np.ndarray, imgs_r: np.ndarray) -> _Chunk:
        s = self.s
        dl, hl = self._upload(imgs_l)
        dr, hr = self._upload(imgs_r)
        outs = stereo_frontend_batch(
            dl, dr, bf=float(s.bf),
            n_features=int(s.fd_features), levels=int(s.fd_levels),
            scale_factor=float(s.fd_scale_factor),
            threshold=float(s.fd_ini_th_fast),
            relaxed=bool(getattr(s, "fd_relaxed_stereo", False)),
        )
        if self.device.type != "cuda":
            return _Chunk(host=outs)
        host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                     for a in outs)
        for h, a in zip(host, outs):
            h.copy_(a, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Chunk(host=host, event=event, uploads=(hl, hr))

    def materialize(self, chunk: _Chunk, frame_ids,
                    timestamps) -> list[FrameData]:
        """Wait for the chunk's (usually already landed) D2H copies and
        build per-frame FrameData."""
        if chunk.event is not None:
            chunk.event.synchronize()
        uv, octave, angle, packed, valid, right, depth = \
            [h.numpy() for h in chunk.host]
        frames = []
        for k, (fid, ts) in enumerate(zip(frame_ids, timestamps)):
            m = valid[k]
            frames.append(FrameData(
                frame_id=int(fid), timestamp=float(ts),
                uv=uv[k][m].astype(np.float64),
                octave=octave[k][m].astype(np.int32),
                angle=angle[k][m].astype(np.float32),
                descriptors=packed[k][m],
                right=right[k][m].astype(np.float64),
                depth=depth[k][m].astype(np.float64),
            ))
        return frames


class PixelFrameSequence:
    """A lazy frame list over rendered or loaded stereo images.

    Quacks like ``list[FrameData]`` for WindowedRunner (len, int and slice
    indexing) but materializes frames chunk by chunk with ``lookahead``
    extraction chunks in flight on the device.  The runner dispatches
    tracking window k before it touches the frames of window k+1, so
    extraction chunks interleave with tracking windows on the device stream
    and the blocking feature fetch overlaps tracking — the analog of the
    reference's detection thread running ahead of tracking
    (Snake/Preprocess/FeatureDetector.cpp:58-80).
    """

    def __init__(self, settings, imgs_l: np.ndarray, imgs_r: np.ndarray,
                 timestamps, gt_poses_cw=None, chunk: int = 64,
                 lookahead: int = 2, *, device):
        self.src = StereoPixelSource(settings, device)
        self.imgs_l = imgs_l
        self.imgs_r = imgs_r
        self.timestamps = list(timestamps)
        self.gt = gt_poses_cw
        self.n = len(imgs_l)
        self.chunk = chunk
        self.lookahead = max(1, lookahead)
        self._futs: dict[int, _Chunk] = {}
        self._done: dict[int, list[FrameData]] = {}

    def __len__(self):
        return self.n

    def _dispatch_chunk(self, c: int):
        if c in self._futs or c in self._done:
            return
        lo = c * self.chunk
        hi = min(lo + self.chunk, self.n)
        if lo >= hi:
            return
        self._futs[c] = self.src.dispatch(self.imgs_l[lo:hi],
                                          self.imgs_r[lo:hi])

    def _ensure(self, c: int):
        """Materialize chunk c, keeping ``lookahead`` chunks in flight."""
        n_chunks = -(-self.n // self.chunk)
        if c >= n_chunks:
            return
        for d in range(c, min(c + 1 + self.lookahead, n_chunks)):
            self._dispatch_chunk(d)
        if c in self._done:
            return
        pending = self._futs.pop(c)
        lo = c * self.chunk
        hi = min(lo + self.chunk, self.n)
        frames = self.src.materialize(pending, range(lo, hi),
                                      self.timestamps[lo:hi])
        if self.gt is not None:
            for i, f in enumerate(frames):
                f.gt_pose_cw = self.gt[lo + i]
        self._done[c] = frames

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(self.n)
            return [self[i] for i in range(lo, hi, step)]
        if idx < 0:
            idx += self.n
        if not 0 <= idx < self.n:
            raise IndexError(f"frame {idx} of {self.n}")
        c = idx // self.chunk
        self._ensure(c)
        return self._done[c][idx - c * self.chunk]
