"""Timing the program's layers from outside: probes around its methods.

``Probe`` is ``chip_smoke.py``'s probe made independent of the program: it
wraps one attribute of a class or module while installed, and sums the
calls and the host seconds inside them (inclusive: a call nested in
another probed one counts in both).  With a ``SpanLog`` it also records
each call's interval, which the trace reader uses to say what the host was
doing while the device sat idle.

``LaunchTally`` counts the hand-written kernels' launches by shape, graph
replays included: the program counts a launch through the function it
passes to ``graphs.count``, and a graph captured while the tally is
installed keeps the tally's function for the shape it captured, so each
replay adds its launches under their shapes.
"""

from __future__ import annotations

import importlib
import time


def resolve(spec: str):
    """``"pkg.module:Class.attr"`` -> (owner object, attribute name)."""
    module, _, path = spec.partition(":")
    owner = importlib.import_module(module)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


class SpanLog:
    """Host intervals (name, start ns, end ns) of probed calls, in
    ``time.perf_counter_ns`` time."""

    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []

    def add(self, name: str, t0: int, t1: int):
        self.spans.append((name, t0, t1))


class Probe:
    """While installed, counts the calls of ``owner.name`` and the host
    seconds inside them; with ``log``, records each call's interval."""

    def __init__(self, spec: str, log: SpanLog | None = None):
        self.owner, self.name = resolve(spec)
        self.label = spec.partition(":")[2]
        self.log = log
        self.calls = 0
        self.seconds = 0.0
        self.inner = None

    def install(self):
        self.inner = inner = getattr(self.owner, self.name)
        log, label = self.log, self.label

        def wrapped(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return inner(*a, **k)
            finally:
                t1 = time.perf_counter_ns()
                self.calls += 1
                self.seconds += (t1 - t0) * 1e-9
                if log is not None:
                    log.add(label, t0, t1)

        setattr(self.owner, self.name, wrapped)

    def remove(self):
        if self.inner is not None:
            setattr(self.owner, self.name, self.inner)
            self.inner = None


class LaunchTally:
    """Launches of the pose and FAST kernels by shape while installed.

    ``pose[(B, N, outer, inner)]`` and ``fast[(B, H, W)]`` count launches,
    eager ones and those a graph replay holds."""

    def __init__(self):
        self.pose: dict = {}
        self.fast: dict = {}
        self._undo = []

    def _adder(self, table, key, count_fn):
        def add(n):
            count_fn(n)
            table[key] = table.get(key, 0) + n
        return add

    def install(self):
        from snakeslam_tpu_torch.ops import orb_kernels as OK
        from snakeslam_tpu_torch.ops import pose_fused as PF

        adders: dict = {}
        pose_launch, pose_count = PF._launch, PF._count_launches
        fast_launch, fast_count = OK._launch_fast, OK._count_fast

        def launch(T_init, points, *a):
            outer, inner = a[-3], a[-2]
            lead = tuple(points.shape[:-1])
            key = (lead[0] if len(lead) == 2 else 1, lead[-1], int(outer),
                   int(inner))
            PF._count_launches = adders.setdefault(
                ("pose", key), self._adder(self.pose, key, pose_count))
            try:
                return pose_launch(T_init, points, *a)
            finally:
                PF._count_launches = pose_count

        def launch_fast(imgs, threshold):
            key = tuple(int(x) for x in imgs.shape)
            OK._count_fast = adders.setdefault(
                ("fast", key), self._adder(self.fast, key, fast_count))
            try:
                return fast_launch(imgs, threshold)
            finally:
                OK._count_fast = fast_count

        PF._launch, OK._launch_fast = launch, launch_fast
        self._undo = [(PF, "_launch", pose_launch),
                      (OK, "_launch_fast", fast_launch)]

    def remove(self):
        for owner, name, value in self._undo:
            setattr(owner, name, value)
        self._undo = []

    def snapshot(self) -> tuple[dict, dict]:
        return dict(self.pose), dict(self.fast)
