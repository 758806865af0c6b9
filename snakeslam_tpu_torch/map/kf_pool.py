"""Device-resident keyframe feature pool.

Counterpart of ``snakeslam_tpu/map/kf_pool.py``.  The mapping back-ends
(the triangulation fan-out and the bidirectional fusion) repeatedly need
the same keyframes' feature tables on the device.  The pool keeps a
fixed-capacity slot table of keyframe feature rows resident there;
consumers index it with a slot vector (one gather for a whole neighbour
stack).  Slots are recycled least-recently-used, so the capacity bounds
memory while the working set (the current keyframe and its covisible
neighbours) always hits.  Keyframe features are immutable, so a resident
row never needs a refresh; erasing a keyframe frees its slot.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.ops.descriptors import unpack_bits
from snakeslam_tpu_torch.ops.matching import FrameFeatures
from snakeslam_tpu_torch.tracking.staging import upload


def pool_features(arrays, slot) -> FrameFeatures:
    """FrameFeatures view of pool rows: ``slot`` is an int (one row) or an
    index tensor (a stack of rows with its leading dims)."""
    uv, right, octave, angle, desc, valid = arrays
    return FrameFeatures(
        uv=uv[slot], right=right[slot], octave=octave[slot],
        angle=angle[slot],
        desc_bits=unpack_bits(desc[slot]).to(torch.int8),
        valid=valid[slot],
    )


class KFFeaturePool:
    def __init__(self, smap, n_slots: int, device, capacity: int = 128):
        self.map = smap
        self.n_slots = n_slots
        self.capacity = capacity
        self.device = torch.device(device)
        S, dev = n_slots, self.device
        self.arrays = (
            torch.zeros((capacity, S, 2), dtype=torch.float32, device=dev),
            torch.full((capacity, S), -1.0, dtype=torch.float32, device=dev),
            torch.zeros((capacity, S), dtype=torch.int32, device=dev),
            torch.zeros((capacity, S), dtype=torch.float32, device=dev),
            torch.zeros((capacity, S, 32), dtype=torch.uint8, device=dev),
            torch.zeros((capacity, S), dtype=torch.bool, device=dev),
        )
        self._slot_of: dict[int, int] = {}
        self._lru: dict[int, int] = {}   # kf -> tick
        self._tick = 0
        smap.on_erase_keyframe.append(self._on_erase)

    def _on_erase(self, kf: int):
        if self._slot_of.pop(int(kf), None) is not None:
            self._lru.pop(int(kf), None)

    def _upload(self, kf: int, slot: int):
        smap = self.map
        S = self.n_slots
        n = min(int(smap.kf_n_feat[kf]), S)
        right = np.full(S, -1.0, dtype=np.float32)
        right[:n] = smap.kf_feat_right[kf, :n]
        rows = (
            np.pad(smap.kf_feat_uv[kf, :n].astype(np.float32),
                   ((0, S - n), (0, 0))),
            right,
            np.pad(smap.kf_feat_octave[kf, :n].astype(np.int32), (0, S - n)),
            np.pad(smap.kf_feat_angle[kf, :n].astype(np.float32), (0, S - n)),
            np.pad(np.ascontiguousarray(smap.kf_feat_desc[kf, :n],
                                        dtype=np.uint8), ((0, S - n), (0, 0))),
            np.arange(S) < n,
        )
        # pinned, non-blocking: the host does not wait for the device work
        # queued ahead of the copy (a pageable copy would)
        for dst, row in zip(self.arrays, rows):
            dst[slot] = upload(row, self.device)

    def slots_for(self, kfs) -> np.ndarray:
        """Ensure every keyframe in ``kfs`` is resident; return its slot
        index vector (int32).  Uploads at most len(kfs) rows; evicts LRU
        rows not in ``kfs`` when full."""
        kfs = [int(k) for k in kfs]
        self._tick += 1
        out = np.empty(len(kfs), dtype=np.int32)
        needed = set(kfs)
        for j, kf in enumerate(kfs):
            slot = self._slot_of.get(kf)
            if slot is None:
                if len(self._slot_of) >= self.capacity:
                    victim = min(
                        (k for k in self._slot_of if k not in needed),
                        key=lambda k: self._lru.get(k, 0),
                    )
                    slot = self._slot_of.pop(victim)
                    self._lru.pop(victim, None)
                else:
                    used = set(self._slot_of.values())
                    slot = next(s for s in range(self.capacity)
                                if s not in used)
                self._upload(kf, slot)
                self._slot_of[kf] = slot
            self._lru[kf] = self._tick
            out[j] = slot
        return out
