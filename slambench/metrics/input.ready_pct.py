"""Dataset input (frontend/input.py): the frames already decoded and
waiting when the consumer asked for them (the input.frames_ready counter)
over the frames it took (input.frames), in %: how often the reader thread
had its decode done ahead; moves fps."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    c = P.counters() or {}
    n = c.get("input.frames", 0)
    return 100.0 * c.get("input.frames_ready", 0) / n if n else None
