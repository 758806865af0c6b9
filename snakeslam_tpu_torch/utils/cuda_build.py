"""Build and load the port's CUDA kernels: one way, one set of flags.

Every kernel source under ``snakeslam_tpu_torch/csrc/`` has a plain C
interface and is compiled by ``nvcc`` into its own shared library under
``snakeslam_tpu_torch/build/`` (git-ignored) at first use, then bound with
``ctypes``.  Nothing is built when a module is imported.  A failed build
raises: a CUDA tensor never falls back to a kernel's plain version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# no --use_fast_math: the FAST kernel must reproduce its plain version's
# f32 arithmetic bit for bit
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def library_path(source: str) -> Path:
    """``csrc/<stem>.cu`` -> ``build/lib<stem>.so``."""
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def _stale(source: str) -> bool:
    lib = library_path(source)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / source).stat().st_mtime)


def build(*sources: str, force: bool = False) -> dict[str, float]:
    """Compile each named ``csrc`` source whose library is missing or older
    than the source (all of them when ``force``), one ``nvcc`` process per
    source, all started together.  Returns the seconds each build took
    (0.0 for a library that was up to date)."""
    todo = [s for s in sources if force or _stale(s)]
    secs = {s: 0.0 for s in sources}
    if not todo:
        return secs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp.so")
        procs[s] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]), tmp)
    failed = []
    while procs:
        for s, (p, tmp) in list(procs.items()):
            rc = p.poll()
            if rc is None:
                continue
            del procs[s]
            secs[s] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, library_path(s))
            else:
                failed.append(f"{s} (nvcc exit {rc})")
        time.sleep(0.02)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + ", ".join(failed))
    return secs


def load(source: str, bind) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if stale.
    ``bind(lib)`` declares the C functions' ``argtypes`` and ``restype``
    once, when the library is first loaded."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build(source)
            lib = ctypes.CDLL(str(library_path(source)))
            bind(lib)
            _loaded[source] = lib
        return lib


def raw_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device, as the int
    a C entry point takes (no Stream object is made)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_launch(err: int, what: str):
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
