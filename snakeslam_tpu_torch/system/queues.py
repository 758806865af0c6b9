"""Delayed work queues: the back-end scheduling substrate.

Replacement for the reference's ``DelayedParallelMapOptimization``
(reference: Snake/System/DelayedParallelMapOptimization.{h,cpp}): each
back-end module (LBA, simplification, deferred mapper, loop closing, IMU
solver) receives keyframes through a queue that dispatches an item only once
``item_id + delay <= latest_id`` (:135-140), runs synchronously
(deterministic mode) or on its own worker thread (:24-33), and supports the
pause / wait-until-paused / resume protocol (:175-189) and force-clean
(:159-173).  A worker that raises stops, and ``join`` / ``force_clean``
re-raise its exception on the caller's thread.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

_JOIN_TIMEOUT_S = 600.0   # a worker's last item: one keyframe's back-end


class DelayedQueue:
    def __init__(self, process: Callable[[int], None], delay: int = 0,
                 parallel: bool = False, name: str = ""):
        self.process = process
        self.delay = delay
        self.parallel = parallel
        self.name = name or process.__qualname__
        self.queue: deque[int] = deque()
        self.latest_id = -1
        self._seq: dict[int, int] = {}  # item -> sequence number
        self._next_seq = 0
        self._lock = threading.Lock()
        self._work = threading.Semaphore(0)
        self._paused = threading.Event()
        self._pause_requested = False
        self._stop = False
        self.error: Exception | None = None
        self._thread = None
        if parallel:
            self._thread = threading.Thread(
                target=self._worker, name=f"queue-{self.name}", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------------

    def add(self, item: int, max_size: int | None = None):
        with self._lock:
            self._seq[item] = self._next_seq
            self._next_seq += 1
            self.queue.append(item)
            if max_size is not None:
                while len(self.queue) > max_size:
                    drop = self.queue.popleft()
                    self._seq.pop(drop, None)
        if self.parallel:
            self._work.release()

    def update(self, latest_item: int):
        """Advance the dispatch horizon; in sync mode, drain ready items
        inline (deterministic, like async=false)."""
        with self._lock:
            self.latest_id = max(self.latest_id,
                                 self._seq.get(latest_item, self._next_seq - 1))
        if not self.parallel:
            self._drain_ready()
        else:
            # wake the worker: items queued earlier may only now satisfy
            # the delay horizon (the add() permit was consumed before the
            # head became ready)
            self._work.release()

    def _ready(self):
        with self._lock:
            if not self.queue:
                return None
            head = self.queue[0]
            if self._seq.get(head, 0) + self.delay <= self.latest_id:
                self.queue.popleft()
                return head
            return None

    def _drain_ready(self):
        while not self._pause_requested:
            item = self._ready()
            if item is None:
                return
            self.process(item)

    # ------------------------------------------------------------------

    def _worker(self):
        while not self._stop:
            self._work.acquire()
            if self._stop:
                return
            if self._pause_requested:
                self._paused.set()
                continue
            # drain everything ready: one wake-up may cover several items
            try:
                while not self._pause_requested:
                    item = self._ready()
                    if item is None:
                        break
                    self.process(item)
            except Exception as e:  # re-raised on the caller's thread
                self.error = e
                return

    def _raise_error(self):
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def pause(self):
        self._pause_requested = True
        if not self.parallel:
            self._paused.set()
        else:
            self._work.release()

    def wait_until_paused(self, timeout: float = 5.0):
        self._paused.wait(timeout)

    def resume(self):
        self._pause_requested = False
        self._paused.clear()
        if self.parallel:
            self._work.release()

    def force_clean(self):
        """Drain everything regardless of delay (ForceCleanQueue)."""
        self._raise_error()
        while True:
            with self._lock:
                if not self.queue:
                    return
                item = self.queue.popleft()
            self.process(item)

    def join(self):
        """Stop the worker after the item it is running, then drain the
        still-ready items inline so the final keyframes' work is never lost
        (the worker may have stopped between add and wake)."""
        self._stop = True
        if self._thread is not None:
            self._work.release()
            self._thread.join(timeout=_JOIN_TIMEOUT_S)
            if self._thread.is_alive():
                raise TimeoutError(f"queue {self.name}: worker still busy "
                                   f"after {_JOIN_TIMEOUT_S} s")
        self._raise_error()
        self._drain_ready()
