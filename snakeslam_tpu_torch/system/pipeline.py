"""Async pipeline: threaded front-end stages + asynchronous local BA.

Counterpart of ``snakeslam_tpu/system/pipeline.py``, mirroring the
reference's deployment-mode concurrency (reference:
Snake/Preprocess/Input.cpp:237-325 camera + grayscale threads,
FeatureDetector.cpp:58-80 detection thread, bounded SynchronizedBuffer
hand-offs — Input.h:48 is 2-deep): a producer thread runs dataset IO +
feature detection + preprocessing, feeding a bounded channel; tracking
consumes on the caller's thread.  Opt-in via ``Settings.async_mode``.

Asynchronous LBA (``Settings.async_lba``) reuses the reference's protocol:
pack under the map lock -> solve lock-free -> commit under the lock with a
generation check (LocalBundleAdjustment.cpp:463-499).

On a CUDA device both threads launch work (the producer ORB's FAST kernel,
the caller the pose kernel and the LBA worker its solve), each on its
current stream; the kernels' launch counters are locked.  An exception on
the producer or the LBA worker is raised on the caller's thread.
"""

from __future__ import annotations

import threading

from snakeslam_tpu_torch.system.queues import DelayedQueue
from snakeslam_tpu_torch.utils.native import NativeChannel

_SENTINEL = "__snakert_sentinel__"
_TIMEOUT_MS = 600_000


class AsyncPipeline:
    """Producer thread (IO + features + preprocess) -> bounded native SPSC
    channel -> tracking on the calling thread.  The 2-deep hand-off mirrors
    the reference's SynchronizedBuffer depth (Input.h:48)."""

    def __init__(self, system, frame_source, depth: int = 2):
        self.system = system
        self.source = frame_source
        self.channel = NativeChannel(capacity=depth)
        self.error = None

    def _producer(self):
        try:
            for frame in self.source:
                if not self.channel.push(frame, timeout_ms=_TIMEOUT_MS):
                    return
        except Exception as e:  # surfaced on the consumer's thread
            self.error = e
        finally:
            self.channel.push(_SENTINEL, timeout_ms=_TIMEOUT_MS)

    def run(self) -> int:
        t = threading.Thread(target=self._producer, name="input-pipeline",
                             daemon=True)
        t.start()
        n = 0
        try:
            while True:
                frame = self.channel.pop(timeout_ms=_TIMEOUT_MS)
                if frame is None or (isinstance(frame, str)
                                     and frame == _SENTINEL):
                    break
                self.system.process_frame(frame)
                n += 1
        finally:
            # a consumer failure must not leave the producer blocked on a
            # full channel
            self.channel.close()
            t.join(timeout=60.0)
        if self.error is not None:
            raise self.error
        return n


class AsyncLBA:
    """Run LocalBA on a worker thread behind a delayed queue
    (async_lba=true: LocalBundleAdjustment.cpp:23-24)."""

    def __init__(self, lba):
        self.lba = lba
        self.queue = DelayedQueue(lba.run, delay=0, parallel=True,
                                  name="lba")

    def add(self, kf: int):
        self.queue.add(kf, max_size=3)
        self.queue.update(kf)

    def run(self, kf: int):
        """One local BA on the caller's thread: the monocular initializer's,
        which must land before tracking goes on."""
        self.lba.run(kf)

    def join(self):
        self.queue.join()
