"""Feature detection module: images -> FrameData, with a disk feature cache.

Counterpart of ``snakeslam_tpu/frontend/feature_detector.py``, mirroring the
reference's FeatureDetector module (Snake/Preprocess/FeatureDetector.{h,cpp}):
ORB extraction (ops/orb.py, in place of ORBExtractor/ORBExtractorGPU,
FeatureDetector.cpp:28-42,113-125) on ``device``, and the feature disk cache
``fd_bufferToFile`` -> ``<dataset>/features/<id>.features``
(FeatureDetector.cpp:94-139), which makes reruns deterministic and fast.
On the card each image goes up from pinned memory without blocking and
through ORB's compiled program (one CUDA graph replay a frame, captured on
the thread that calls: async mode's producer captures its own); the
features come back by one copy behind one event.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.ops.descriptors import pack_bits_np
from snakeslam_tpu_torch.ops.orb import extract_orb
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.system.settings import Settings
from snakeslam_tpu_torch.tracking.staging import HostCopy, upload
from snakeslam_tpu_torch.utils import native


class FeatureDetector:
    def __init__(self, settings: Settings, cache_dir: str | None = None, *,
                 device):
        self.s = settings
        self.device = torch.device(device)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir and settings.fd_buffer_to_file:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _cache_path(self, frame_id: int) -> Path | None:
        if self.cache_dir is None or not self.s.fd_buffer_to_file:
            return None
        return self.cache_dir / f"{frame_id}.features"

    def detect(self, image: np.ndarray, frame_id: int,
               timestamp: float) -> FrameData:
        """Run ORB on a grayscale image (H, W) uint8/float."""
        with tracer.span("orb.detect", frame_id):
            path = self._cache_path(frame_id)
            if path is not None:
                z = native.read_features(path)
                if z is not None:
                    return FrameData(
                        frame_id=frame_id, timestamp=timestamp,
                        uv=z["uv"], octave=z["octave"], angle=z["angle"],
                        descriptors=z["descriptors"],
                        right=np.full(len(z["uv"]), -1.0),
                        depth=np.full(len(z["uv"]), -1.0),
                    )
            feats = extract_orb(
                upload(np.asarray(image, dtype=np.float32), self.device),
                n_features=int(self.s.fd_features),
                levels=int(self.s.fd_levels),
                scale_factor=float(self.s.fd_scale_factor),
                threshold=float(self.s.fd_ini_th_fast),
            )
            feats = HostCopy(feats).wait()
            uv_all, _, octave_all, angle_all, bits_all, valid = feats
            uv = uv_all[valid].astype(np.float64)
            octave = octave_all[valid].astype(np.int32)
            angle = angle_all[valid].astype(np.float32)
            desc = pack_bits_np(bits_all[valid])
            if path is not None:
                native.write_features(path, uv, octave, angle, desc)
            n = len(uv)
            return FrameData(
                frame_id=frame_id, timestamp=timestamp,
                uv=uv, octave=octave, angle=angle, descriptors=desc,
                right=np.full(n, -1.0), depth=np.full(n, -1.0),
            )
