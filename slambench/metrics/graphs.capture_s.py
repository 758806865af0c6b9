"""Graph layer (utils/graphs.py): the graphs.capture spans (a program's
eager first run and its capture, for a key met first), seconds in the
window; moves fps."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    recs = P.spans()
    if recs is None:
        return None
    return sum(P.durations_ns(recs, "graphs.capture")) * 1e-9
