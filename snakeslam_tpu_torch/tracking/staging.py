"""Host<->device staging: padded frame and keyframe features, uploads, and
result copies back to the host.

Counterpart of ``snakeslam_tpu/tracking/staging.py`` (``pad_frame_features``,
``kf_features_cached``, ``snapshot_points``).  On a CUDA
device, uploads go through pinned memory with non-blocking copies and
results come back into pinned tensors behind a recorded CUDA event, so
neither direction makes the host wait for device work already queued.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.ops.descriptors import unpack_bits
from snakeslam_tpu_torch.ops.matching import FrameFeatures, LocalMapPoints

F32 = np.float32


def pad_frames_features(frames: list[FrameData], n_slots: int,
                        device) -> FrameFeatures:
    """Frames padded to ``n_slots`` feature slots and stacked on a leading
    batch dim on ``device``, packed on the host and uploaded once per
    field; descriptors travel packed (32 B) and expand to bit planes on
    the device."""
    B = len(frames)
    uv = np.zeros((B, n_slots, 2), dtype=F32)
    right = np.full((B, n_slots), -1.0, dtype=F32)
    octave = np.zeros((B, n_slots), dtype=np.int32)
    angle = np.zeros((B, n_slots), dtype=F32)
    desc = np.zeros((B, n_slots, 32), dtype=np.uint8)
    valid = np.zeros((B, n_slots), dtype=bool)
    for b, f in enumerate(frames):
        n = min(f.n, n_slots)
        uv[b, :n] = f.uv[:n]
        right[b, :n] = f.right[:n]
        octave[b, :n] = f.octave[:n]
        angle[b, :n] = f.angle[:n]
        desc[b, :n] = f.descriptors[:n]
        valid[b, :n] = True
    return FrameFeatures(
        uv=upload(uv, device), right=upload(right, device),
        octave=upload(octave, device), angle=upload(angle, device),
        desc_bits=unpack_bits(upload(desc, device)).to(torch.int8),
        valid=upload(valid, device))


def pad_frame_features(frame: FrameData, n_slots: int,
                       device) -> FrameFeatures:
    """One frame padded to ``n_slots`` feature slots on ``device``."""
    return FrameFeatures(*(t[0] for t in pad_frames_features(
        [frame], n_slots, device)))


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a CUDA device the copy
    goes from pinned memory without blocking: queued device work keeps
    running, and the pinned block is not reused before the copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """Device tensors copied to the host behind the work queued so far:
    ``ready()`` polls without blocking, ``wait()`` returns numpy arrays."""

    def __init__(self, tensors):
        tensors = list(tensors)
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tensors

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def snapshot_points(smap: SlamMap, point_ids: np.ndarray, n_slots: int,
                    device):
    """A LocalMapPoints snapshot of ``point_ids`` on ``device``, gathered
    on the host from the map's arrays (loop verification snapshots the
    candidate keyframe's points this way).

    Returns (LocalMapPoints, ids used (int64, <= n_slots))."""
    ids = np.asarray(point_ids[:n_slots], dtype=np.int64)
    n = len(ids)
    pos = np.zeros((n_slots, 3), dtype=F32)
    normal = np.zeros((n_slots, 3), dtype=F32)
    bits = np.zeros((n_slots, 256), dtype=np.int8)
    ref_depth = np.ones(n_slots, dtype=F32)
    ref_level = np.zeros(n_slots, dtype=np.int32)
    pos[:n] = smap.pt_pos[ids]
    normal[:n] = smap.pt_normal[ids]
    bits[:n] = smap.pt_bits[ids]
    ref_depth[:n] = smap.pt_ref_depth[ids]
    ref_level[:n] = smap.pt_ref_level[ids]
    lm = LocalMapPoints(
        position=upload(pos, device), normal=upload(normal, device),
        desc_bits=upload(bits, device), ref_depth=upload(ref_depth, device),
        ref_level=upload(ref_level, device),
        angle=upload(np.zeros(n_slots, dtype=F32), device),
        valid=upload(np.arange(n_slots) < n, device))
    return lm, ids


def kf_features_cached(smap: SlamMap, kf: int, n_slots: int,
                       device) -> FrameFeatures:
    """Device-side FrameFeatures of a keyframe's stored features.

    Keyframe features are immutable, so the staged tensors are cached on
    the map (evicted when the keyframe is erased, dropped by ``clear()``)."""
    cache = smap.__dict__.setdefault("_kf_feat_cache", {})
    hit = cache.get(kf)
    if hit is not None and hit[0] == n_slots:
        return hit[1]
    n = min(int(smap.kf_n_feat[kf]), n_slots)
    right = np.full(n_slots, -1.0, dtype=F32)
    right[:n] = smap.kf_feat_right[kf, :n]
    desc = np.zeros((n_slots, 32), dtype=np.uint8)
    desc[:n] = smap.kf_feat_desc[kf, :n]
    ff = FrameFeatures(
        uv=upload(np.pad(smap.kf_feat_uv[kf, :n],
                         ((0, n_slots - n), (0, 0))).astype(F32), device),
        right=upload(right, device),
        octave=upload(np.pad(smap.kf_feat_octave[kf, :n].astype(np.int32),
                             (0, n_slots - n)), device),
        angle=upload(np.pad(smap.kf_feat_angle[kf, :n],
                            (0, n_slots - n)).astype(F32), device),
        desc_bits=unpack_bits(upload(desc, device)).to(torch.int8),
        valid=upload(np.arange(n_slots) < n, device),
    )
    cache[kf] = (n_slots, ff)
    return ff
