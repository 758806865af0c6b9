"""Per-module performance statistics.

Replacement for the reference's Module/PerformanceStats registry with its
RAII ScopedModuleTimer (reference: Snake/System/Module.h:38-95) and the
end-of-run mean-ms + Hz table (Snake/System/Module.cpp:78-100).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class PerformanceStats:
    def __init__(self):
        self.timings: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def timer(self, module: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[module].append((time.perf_counter() - t0) * 1e3)

    def mean_ms(self, module: str) -> float:
        t = self.timings.get(module)
        return float(np.mean(t)) if t else 0.0

    def hz(self, module: str) -> float:
        m = self.mean_ms(module)
        return 1000.0 / m if m > 0 else 0.0

    def table(self) -> str:
        lines = [f"{'Module':<20}{'Mean (ms)':>12}{'Hz':>10}{'Count':>8}"]
        for name, ts in sorted(self.timings.items()):
            m = float(np.mean(ts))
            lines.append(
                f"{name:<20}{m:>12.3f}{(1000.0 / m if m > 0 else 0):>10.1f}"
                f"{len(ts):>8}"
            )
        return "\n".join(lines)
