"""Device-resident mirror of the map's point table.

Counterpart of ``snakeslam_tpu/map/device_mirror.py``.  The host map
(SlamMap) is authoritative; the mirror keeps the per-point payload
(position, normal, packed descriptor, scale-region data) on the device so
a local-map snapshot is a device-side gather of an id array.  It refreshes
lazily when the map's generation counter moves (keyframe rate).
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import SlamMap
from snakeslam_tpu_torch.ops.descriptors import unpack_bits
from snakeslam_tpu_torch.ops.matching import LocalMapPoints


def _bucket(n: int, minimum: int = 4096) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _gather_points(table: torch.Tensor, ids: torch.Tensor,
                   aux: torch.Tensor) -> LocalMapPoints:
    """table: (cap, 16) f32 rows = [pos3 | normal3 | depth | level |
    descriptor bytes bit-cast to f32 x8]; ids (n_slots,) int32; aux
    (n_slots, 3) f32 = [valid | angle | octave-or-(-1)].

    The descriptor columns hold arbitrary bit patterns (some are NaN
    payloads): they are only indexed, sliced and re-viewed as bytes, never
    passed through arithmetic."""
    valid = aux[:, 0] > 0.5
    angle = aux[:, 1]
    octave_override = aux[:, 2].to(torch.int32)
    use_override = aux[0, 2] >= 0.0
    idx = torch.clamp(ids, 0, table.shape[0] - 1).long()
    rows = table[idx]
    lvl = torch.where(use_override, octave_override,
                      rows[:, 7].to(torch.int32))
    desc_packed = rows[:, 8:16].contiguous().view(torch.uint8)
    return LocalMapPoints(
        position=rows[:, :3],
        normal=rows[:, 3:6],
        desc_bits=unpack_bits(desc_packed).to(torch.int8),
        ref_depth=rows[:, 6],
        ref_level=lvl,
        angle=angle,
        valid=valid,
    )


class DeviceMapMirror:
    def __init__(self, smap: SlamMap, device):
        self.map = smap
        self.device = torch.device(device)
        self.synced_state = -1
        self.capacity = 0
        self._table = None

    def sync(self):
        """Refresh the device copy if the map mutated since the last sync."""
        smap = self.map
        if smap.state == self.synced_state and self._table is not None:
            return
        n = max(smap._next_pt, 1)
        cap = _bucket(n)
        table = np.empty((cap, 16), dtype=np.float32)
        table[:, :3] = smap.pt_pos[:cap]
        table[:, 3:6] = smap.pt_normal[:cap]
        table[:, 6] = smap.pt_ref_depth[:cap]
        table[:, 7] = smap.pt_ref_level[:cap]
        table[:, 8:16] = np.ascontiguousarray(
            smap.pt_desc[:cap]).view(np.float32)
        # a blocking copy from pageable memory: ``table`` may be freed after
        self._table = torch.from_numpy(table).to(self.device)
        self.capacity = cap
        self.synced_state = smap.state

    def gather(self, point_ids: np.ndarray, n_slots: int,
               angles: np.ndarray | None = None,
               octaves: np.ndarray | None = None):
        """Build a LocalMapPoints snapshot on the device from host point ids.

        Returns (LocalMapPoints, ids used (int64, <= n_slots))."""
        self.sync()
        ids = np.asarray(point_ids[:n_slots], dtype=np.int32)
        n = len(ids)
        ids_pad = np.zeros(n_slots, dtype=np.int32)
        ids_pad[:n] = ids
        aux = np.zeros((n_slots, 3), dtype=np.float32)
        aux[:n, 0] = 1.0
        if angles is not None:
            aux[:n, 1] = angles[:n]
        if octaves is not None:
            aux[:n, 2] = octaves[:n]
        else:
            aux[:, 2] = -1.0
        lm = _gather_points(self._table,
                            torch.from_numpy(ids_pad).to(self.device),
                            torch.from_numpy(aux).to(self.device))
        return lm, ids.astype(np.int64)
