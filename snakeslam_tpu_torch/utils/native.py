"""ctypes bindings for the native runtime library (native/snakert.cpp).

Counterpart of ``snakeslam_tpu/utils/native.py``: the SPSC channel and the
binary feature cache.  The port compiles the shared ``native/snakert.cpp``
with g++ on first use into its own build directory
(``snakeslam_tpu_torch/build/libsnakert.so``, git-ignored) and never writes
into ``native/``.  Every entry point has a pure-Python fallback so the
framework runs without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "snakert.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "build" / "libsnakert.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build():
    """g++ into a temporary name, then an atomic rename: concurrent test
    workers never load a half-written library."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-o", str(tmp), str(_SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, _LIB_PATH)


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _SOURCE.exists():
            _build_failed = True
            return None
        if (not _LIB_PATH.exists()
                or _LIB_PATH.stat().st_mtime < _SOURCE.stat().st_mtime):
            try:
                _build()
            except (OSError, subprocess.SubprocessError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _build_failed = True
            return None
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_int]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_int]
        lib.ring_pop.restype = ctypes.c_int
        lib.ring_pop.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_int]
        lib.ring_close.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_int
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.features_write.restype = ctypes.c_int
        lib.features_count.restype = ctypes.c_int
        lib.features_read.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# SPSC channel (SynchronizedBuffer analog)
# ---------------------------------------------------------------------------

class NativeChannel:
    """Bounded channel passing Python objects via a native token ring.

    Falls back to queue.Queue semantics when the native library is missing.
    """

    def __init__(self, capacity: int = 2):
        self._lib = _load()
        self._payload: dict[int, object] = {}
        self._next_token = 1
        self._py_lock = threading.Lock()
        if self._lib is not None:
            self._ring = self._lib.ring_create(capacity)
        else:
            import queue

            self._q = queue.Queue(maxsize=capacity)

    def push(self, obj, timeout_ms: int = 60_000) -> bool:
        if self._lib is None:
            import queue

            try:
                self._q.put(obj, timeout=timeout_ms / 1e3)
                return True
            except queue.Full:
                return False
        with self._py_lock:
            token = self._next_token
            self._next_token += 1
            self._payload[token] = obj
        r = self._lib.ring_push(self._ring, token, timeout_ms)
        if r != 1:
            with self._py_lock:
                self._payload.pop(token, None)
        return r == 1

    def pop(self, timeout_ms: int = 60_000):
        """Returns the object, or None on timeout/closed-empty."""
        if self._lib is None:
            import queue

            try:
                return self._q.get(timeout=timeout_ms / 1e3)
            except queue.Empty:
                return None
        out = ctypes.c_uint64()
        r = self._lib.ring_pop(self._ring, ctypes.byref(out), timeout_ms)
        if r != 1:
            return None
        with self._py_lock:
            return self._payload.pop(int(out.value), None)

    def close(self):
        if self._lib is not None:
            self._lib.ring_close(self._ring)

    def __del__(self):
        try:
            if self._lib is not None and self._ring:
                self._lib.ring_destroy(self._ring)
                self._ring = None
        except Exception:
            pass


# ---------------------------------------------------------------------------
# binary feature cache (fd_bufferToFile parity, FeatureDetector.cpp:94-139)
# ---------------------------------------------------------------------------

def write_features(path, uv: np.ndarray, octave: np.ndarray,
                   angle: np.ndarray, descriptors: np.ndarray) -> bool:
    lib = _load()
    n = len(uv)
    if lib is None:
        np.savez(str(path) + ".npz", uv=uv, octave=octave, angle=angle,
                 descriptors=descriptors)
        return True
    uv = np.ascontiguousarray(uv, dtype=np.float64)
    octave = np.ascontiguousarray(octave, dtype=np.int32)
    angle = np.ascontiguousarray(angle, dtype=np.float32)
    desc = np.ascontiguousarray(descriptors, dtype=np.uint8)
    r = lib.features_write(
        str(path).encode(), n,
        uv.ctypes.data_as(ctypes.c_void_p),
        octave.ctypes.data_as(ctypes.c_void_p),
        angle.ctypes.data_as(ctypes.c_void_p),
        desc.ctypes.data_as(ctypes.c_void_p),
    )
    return r == 0


def read_features(path):
    """Returns dict(uv, octave, angle, descriptors) or None."""
    lib = _load()
    if lib is None:
        p = Path(str(path) + ".npz")
        if not p.exists():
            return None
        z = np.load(p)
        return dict(uv=z["uv"], octave=z["octave"], angle=z["angle"],
                    descriptors=z["descriptors"])
    if not Path(path).exists():
        return None
    n = lib.features_count(str(path).encode())
    if n < 0:
        return None
    uv = np.empty((n, 2), dtype=np.float64)
    octave = np.empty(n, dtype=np.int32)
    angle = np.empty(n, dtype=np.float32)
    desc = np.empty((n, 32), dtype=np.uint8)
    r = lib.features_read(
        str(path).encode(), n,
        uv.ctypes.data_as(ctypes.c_void_p),
        octave.ctypes.data_as(ctypes.c_void_p),
        angle.ctypes.data_as(ctypes.c_void_p),
        desc.ctypes.data_as(ctypes.c_void_p),
    )
    if r != 0:
        return None
    return dict(uv=uv, octave=octave, angle=angle, descriptors=desc)
