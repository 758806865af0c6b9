"""Host<->device staging: padded frame and keyframe features, uploads, and
result copies back to the host.

Counterpart of ``snakeslam_tpu/tracking/staging.py`` (``pad_frame_features``,
``kf_features_cached``; point snapshots come with loop closing).  On a CUDA
device, uploads go through pinned memory with non-blocking copies and
results come back into pinned tensors behind a recorded CUDA event, so
neither direction makes the host wait for device work already queued.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.ops.descriptors import unpack_bits
from snakeslam_tpu_torch.ops.matching import FrameFeatures

F32 = np.float32


def pad_frame_features(frame: FrameData, n_slots: int,
                       device) -> FrameFeatures:
    """Pad a frame to ``n_slots`` feature slots on ``device``; descriptors
    travel packed (32 B) and expand to bit planes on the device."""
    n = min(frame.n, n_slots)
    uv = np.zeros((n_slots, 2), dtype=F32)
    right = np.full(n_slots, -1.0, dtype=F32)
    octave = np.zeros(n_slots, dtype=np.int32)
    angle = np.zeros(n_slots, dtype=F32)
    desc = np.zeros((n_slots, 32), dtype=np.uint8)
    uv[:n] = frame.uv[:n]
    right[:n] = frame.right[:n]
    octave[:n] = frame.octave[:n]
    angle[:n] = frame.angle[:n]
    desc[:n] = frame.descriptors[:n]
    valid = np.arange(n_slots) < n

    def up(a):
        return torch.from_numpy(a).to(device)

    return FrameFeatures(
        uv=up(uv), right=up(right), octave=up(octave), angle=up(angle),
        desc_bits=unpack_bits(up(desc)).to(torch.int8), valid=up(valid),
    )


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
