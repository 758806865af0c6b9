"""What a traffic generator hands the harness: one ``Sequence`` per
session, and one for the warm-up.

A generator is a module ``traffic/<generator>.py``, named by a cell's
traffic file, that defines ``sequences(cell, seeds, workdir)`` and returns
``(the session sequences, the warm-up sequence)``.  ``seeds`` holds one
32-bit seed per session sequence and one more for the warm-up, drawn from
the run's seed; whatever the generator writes goes under ``workdir``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class Sequence:
    raw: list = field(default_factory=list)      # raw frames, windowed entry
    root: Path | None = None                     # dataset directory written
    images: list = field(default_factory=list)   # by frame id, the image
                                                 #   files the ORB check reads
    frames: int = 0
    truth: np.ndarray | None = None              # true camera centres by
                                                 #   frame id, where known


def true_centres(raw) -> np.ndarray:
    """The generator's camera centres -R^T t of ``raw`` frames, by id."""
    T = np.stack([r.gt_pose_cw for r in raw]).astype(np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])
