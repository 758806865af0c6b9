"""Per-frame tracker (tracking/tracker.py): the fine local-map snapshots
built anew (the tracker.fine_map_rebuilds counter) over the frames that
reached the tracking steps (tracker.frames), in %: the fine snapshot
cache's misses; moves fps."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    c = P.counters() or {}
    n = c.get("tracker.frames", 0)
    return 100.0 * c.get("tracker.fine_map_rebuilds", 0) / n if n else None
