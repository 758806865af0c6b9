"""Host->device staging: pad a frame's features to the fixed slot count.

Counterpart of ``pad_frame_features`` in ``snakeslam_tpu/tracking/staging.py``
(keyframe feature caching comes with the deferred keyframe cycle, point
snapshots with loop closing).
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData
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
