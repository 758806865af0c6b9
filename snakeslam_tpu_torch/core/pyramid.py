"""Scale-pyramid constant tables.

Replacement for saiga's ``ScalePyramid`` (reference: Snake/Map/Features.h:16,
Snake/Preprocess/FeatureDetector.cpp:51): per-octave scale factors, squared
sigmas, and the scale-prediction helpers used by matching gates and
information weights (1/sigma^2 per octave, used throughout pose refinement —
reference: Snake/Tracking/PoseRefinement.h:52).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ScalePyramid(NamedTuple):
    levels: int
    scale_factor: float
    scales: np.ndarray        # (L,) scale of each octave: factor**level
    inv_scales: np.ndarray    # (L,)
    sigma2: np.ndarray        # (L,) scales**2
    inv_sigma2: np.ndarray    # (L,)
    log_scale_factor: float

    @staticmethod
    def create(levels: int = 4, scale_factor: float = 1.2) -> "ScalePyramid":
        scales = scale_factor ** np.arange(levels, dtype=np.float32)
        return ScalePyramid(
            levels=levels,
            scale_factor=float(scale_factor),
            scales=scales,
            inv_scales=(1.0 / scales).astype(np.float32),
            sigma2=(scales**2).astype(np.float32),
            inv_sigma2=(1.0 / scales**2).astype(np.float32),
            log_scale_factor=float(np.log(scale_factor)),
        )

    def predict_level(self, dist: np.ndarray, max_distance: np.ndarray) -> np.ndarray:
        """Predicted octave for a point seen at `dist` whose max view distance
        is `max_distance` (ORB-SLAM scale-prediction rule)."""
        ratio = np.maximum(max_distance / np.maximum(dist, 1e-9), 1e-9)
        level = np.ceil(np.log(ratio) / self.log_scale_factor)
        return np.clip(level, 0, self.levels - 1).astype(np.int32)
