"""The device trace of a window: kernel intervals, busy time, idle gaps.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity over the
measured window and reads the device's operations (kernels, copies,
memsets) from it.  The profiler's clock is tied to the host's
``perf_counter_ns`` by a marker kernel launched on an idle device at the
window's start, so host spans can be laid over the device timeline.
"""

from __future__ import annotations

import time

import numpy as np
import torch

MARKER_CYCLES = 20_000
MARKER_NAMES = ("spin_kernel", "sleep")


def _kinds():
    from torch.autograd import DeviceType
    return DeviceType


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.host_open_ns = None
        self.host_close_ns = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.host_open_ns = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)       # the clock marker
        torch.cuda.synchronize()

    def stop(self):
        torch.cuda.synchronize()
        self.host_close_ns = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def device_ops(self):
        """(distinct names, each operation's name index, start ns, end ns)
        of every device operation, in host
        ``perf_counter_ns`` time, the marker left out.  Read from the
        profiler's raw events: building its per-event Python objects
        takes minutes for the millions of kernels a window replays."""
        cuda = _kinds().CUDA
        index: dict[str, int] = {}
        ids, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                ids.append(index.setdefault(e.name(), len(index)))
                starts.append(e.start_ns())
                ends.append(e.end_ns())
        names = list(index)
        ids = np.asarray(ids, dtype=np.int64)
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        is_marker = np.isin(ids, [i for i, n in enumerate(names)
                                  if any(m in n for m in MARKER_NAMES)])
        if not is_marker.any():
            raise RuntimeError("the trace holds no clock marker kernel")
        # the marker ran first on an idle device: its start is the host's
        # clock at the window's open
        first = int(np.argmin(np.where(is_marker, starts,
                                       np.iinfo(np.int64).max)))
        offset = self.host_open_ns - starts[first]
        keep = np.ones(len(ids), dtype=bool)
        keep[first] = False
        return names, ids[keep], starts[keep] + offset, ends[keep] + offset


def busy_intervals(starts, ends, lo: int, hi: int):
    """The union of the intervals [starts, ends), clipped to [lo, hi]:
    (merged starts, merged ends), int64 arrays."""
    a = np.clip(starts, lo, hi)
    b = np.clip(ends, lo, hi)
    keep = b > a
    a, b = a[keep], b[keep]
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    if not len(a):
        return a, b
    reach = np.maximum.accumulate(b)
    # a new run of busy time starts where an interval begins past the
    # farthest end reached so far
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    run_end = np.append(idx[1:] - 1, len(a) - 1)
    return a[idx], reach[run_end]


def gaps(bs, be, lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle intervals of [lo, hi] between merged busy runs."""
    starts = np.concatenate([[lo], be])
    ends = np.concatenate([bs, [hi]])
    keep = ends > starts
    return list(zip(starts[keep].tolist(), ends[keep].tolist()))


def innermost_segments(spans) -> list[tuple[int, int, str]]:
    """The host timeline cut into segments, each labelled with the
    innermost span open over it (spans nest: a probed call inside
    another)."""
    events = []
    for i, (name, a, b) in enumerate(spans):
        events.append((a, 1, -(b - a), i, name))
        events.append((b, 0, 0, i, name))
    events.sort()
    stack: list[tuple[int, str]] = []
    out = []
    t_prev = None
    for t, kind, _, i, name in events:
        if stack and t_prev is not None and t > t_prev:
            out.append((t_prev, t, stack[-1][1]))
        if kind == 1:
            stack.append((i, name))
        else:
            for j in range(len(stack) - 1, -1, -1):
                if stack[j][0] == i:
                    del stack[j]
                    break
        t_prev = t
    return out


def idle_by_span(idle, segments) -> dict[str, float]:
    """Seconds of the idle gaps by the innermost host span over them;
    ``"(no span)"`` where none was open."""
    out: dict[str, float] = {}
    j = 0
    for a, b in idle:
        covered = 0
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, name = segments[k]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov * 1e-9
                covered += ov
            k += 1
        if b - a > covered:
            out["(no span)"] = (out.get("(no span)", 0.0)
                                + (b - a - covered) * 1e-9)
    return out


def summarize(trace: DeviceTrace, spans) -> dict:
    """busy_s, window_s, per-name device seconds and counts, the idle
    seconds by host span."""
    lo, hi = trace.host_open_ns, trace.host_close_ns
    names, ids, starts, ends = trace.device_ops()
    bs, be = busy_intervals(starts, ends, lo, hi)
    a = np.clip(starts, lo, hi)
    d = (np.clip(ends, lo, hi) - a).clip(min=0) * 1e-9
    secs = np.bincount(ids, weights=d, minlength=len(names))
    counts = np.bincount(ids, weights=(d > 0), minlength=len(names))
    ops = {n: [float(s), int(c)] for n, s, c in zip(names, secs, counts)
           if c > 0}
    return dict(busy_s=float((be - bs).sum()) * 1e-9,
                window_s=(hi - lo) * 1e-9, ops=ops, n_ops=len(ids),
                idle_by_span=idle_by_span(gaps(bs, be, lo, hi),
                                          innermost_segments(spans)))
