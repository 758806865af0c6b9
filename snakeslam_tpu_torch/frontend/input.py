"""Input module: dataset -> feature detection -> preprocessing -> FrameData.

Counterpart of ``snakeslam_tpu/frontend/input.py``, mirroring the
reference's Input + FeatureDetector + Preprocess pipeline stages
(reference: Snake/Preprocess/Input.cpp:240-325 camera/grayscale threads,
FeatureDetector.cpp:58-80, Preprocess.cpp:16-31) on ``device``: ORB (the
FAST kernel on a CUDA device), keypoint undistortion, the RGB-D depth
filter and stereo matching.  The dataset's own step (file reads, image
decoding, depth scaling, IMU slicing) runs on a reader thread, two frames
ahead through a bounded channel as the reference's camera threads hand
frames over (Input.h:48); the stages after it run inline per frame on the
consumer's thread, which alone touches torch.  Async mode (a producer
thread running those stages too) is system/pipeline.py.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Distortion
from snakeslam_tpu_torch.frontend.datasets import RawFrame, create_dataset
from snakeslam_tpu_torch.frontend.depth_processor import DepthProcessor
from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
from snakeslam_tpu_torch.frontend.preprocess import Preprocess
from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.utils.native import NativeChannel

_AHEAD = 2            # frames decoded ahead (the reference's buffer)
_PUSH_MS = 100        # the reader's push timeout: how often it sees a stop
_TAKE_MS = 60_000


class _End:
    """The reader's last item: the end of the dataset, or ``error``, the
    exception its step raised."""

    def __init__(self, error: BaseException | None = None):
        self.error = error


def _hand_over(channel: NativeChannel, item, stop: threading.Event) -> bool:
    """Push ``item`` unless ``stop`` is set first."""
    while not stop.is_set():
        if channel.push(item, timeout_ms=_PUSH_MS):
            return True
    return False


def _read_ahead(it, channel: NativeChannel, stop: threading.Event):
    """The reader thread: steps the dataset iterator ``it`` ahead of the
    consumer and hands over each frame, then an ``_End``, holding the
    exception the step raised if one did: the consumer raises it in that
    frame's place.  It touches no torch; it ends early once ``stop`` is
    set."""
    try:
        while not stop.is_set():
            with tracer.span("input.decode") as sp:
                raw = next(it, None)
                if raw is not None:
                    sp.set_frame(raw.frame_id)
            if raw is None:
                break
            if not _hand_over(channel, raw, stop):
                return
        last = _End()
    except BaseException as e:      # re-raised on the consumer
        last = _End(e)
    _hand_over(channel, last, stop)


class Input:
    def __init__(self, settings: Settings, dataset_root: str | None = None,
                 dataset=None, *, device):
        self.s = settings
        self.device = torch.device(device)
        self.dataset = dataset or (
            create_dataset(settings, dataset_root) if dataset_root else None
        )
        # propagate calibration from the dataset (Input.cpp:32-51)
        calib = getattr(self.dataset, "calib", None)
        if calib:
            for key in ("fx", "fy", "cx", "cy", "width", "height"):
                if key in calib:
                    setattr(settings, key, calib[key])
            if "bf" in calib:
                settings.bf = float(calib["bf"])
        dist = None
        if calib and calib.get("distortion"):
            d = calib["distortion"]
            dist = Distortion.create(*(list(d) + [0.0] * (4 - len(d)))[:4],
                                     device=self.device)
        cache = None
        if dataset_root and settings.fd_buffer_to_file:
            cache = str(dataset_root) + "/features"
        self.detector = FeatureDetector(settings, cache_dir=cache,
                                        device=self.device)
        self.preprocess = Preprocess(settings, distortion=dist,
                                     device=self.device)
        self.depth_processor = None
        if settings.depth_filter_enable and settings.bf > 0:
            self.depth_processor = DepthProcessor(
                fx=settings.fx, bf=settings.bf,
                gauss_radius=settings.depth_filter_gauss_radius,
                hyst_min=settings.depth_filter_hyst_min,
                hyst_max=settings.depth_filter_hyst_max,
                device=self.device,
            )

    # ------------------------------------------------------------------

    def process_raw(self, raw: RawFrame) -> FrameData:
        frame = self.detector.detect(raw.gray, raw.frame_id, raw.timestamp)
        self.preprocess.undistort_keypoints(frame)
        if raw.depth is not None:
            with tracer.span("input.depth", raw.frame_id):
                depth = raw.depth
                if self.depth_processor is not None:
                    depth = self.depth_processor.process(depth)
                self.preprocess.depth_from_rgbd(frame, depth)
        elif raw.right is not None and self.s.input_type == InputType.Stereo:
            right_frame = self.detector.detect(
                raw.right, raw.frame_id + 10_000_000, raw.timestamp
            )
            self.preprocess.stereo_match(frame, right_frame)
        if raw.imu_omega is not None and len(raw.imu_omega):
            frame.imu_omega = raw.imu_omega
            frame.imu_acc = raw.imu_acc
            frame.imu_t = raw.imu_t
            dt = np.diff(raw.imu_t, append=raw.timestamp)
            frame.imu_dt = np.maximum(dt, 1e-5)
        return frame

    def __iter__(self):
        yield from self.frames()

    def frames(self, paced: bool | None = None):
        """Iterate processed frames, optionally paced to playback_fps.

        The reference's deployment mode replays datasets at wall-clock
        rate (DatasetCameraBase::ResetTime, Input.cpp:240-303): frame k is
        delivered no earlier than
        ``start + (t_k - t_0) * native_fps / playback_fps``.
        ``playback_fps <= 0`` (or paced=False) replays as fast as
        possible — the evaluation mode.

        A reader thread steps the dataset (``input.decode`` spans, on its
        thread) up to two frames ahead; this generator takes them in order
        (``input.wait``, the take; the counters ``input.frames`` and
        ``input.frames_ready``, frames already waiting when asked) and
        raises where the dataset raised.  Closing it, or its end, stops
        and joins the reader."""
        if paced is None:
            paced = self.s.dataset.playback_paced
        rate = float(self.s.dataset.playback_fps)
        t0_data = None
        t0_wall = time.perf_counter()
        native = None
        prev_ts = None
        it = iter(self.dataset)
        channel = NativeChannel(capacity=_AHEAD)
        stop = threading.Event()
        reader = threading.Thread(target=_read_ahead, name="input-reader",
                                  args=(it, channel, stop), daemon=True)
        reader.start()
        try:
            while True:
                with tracer.span("input.wait") as sp:
                    raw = channel.pop(timeout_ms=0)
                    ready = raw is not None
                    while raw is None:
                        raw = channel.pop(timeout_ms=_TAKE_MS)
                    if isinstance(raw, _End):
                        if raw.error is not None:
                            raise raw.error
                        return
                    sp.set_frame(raw.frame_id)
                tracer.count("input.frames")
                tracer.count("input.frames_ready", int(ready))
                if paced and rate > 0:
                    if t0_data is None:
                        t0_data = raw.timestamp
                    elif native is None and raw.timestamp > prev_ts:
                        native = 1.0 / (raw.timestamp - prev_ts)
                    if native is not None:
                        target = t0_wall + (raw.timestamp - t0_data) \
                            * native / rate
                        delay = target - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    prev_ts = raw.timestamp
                yield self.process_raw(raw)
        finally:
            # an early close (the consumer stopped or failed) must not
            # leave the reader blocked on a full channel
            stop.set()
            channel.close()
            reader.join()
