"""Keyframe cycle (mapping/local_mapping.py): the kf_cycle.wait span, the
host blocked on a cycle's readback in commit_deferred, in ms a cycle;
moves frame_ms_p95."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    d = P.durations_ns(P.spans() or [], "kf_cycle.wait")
    return sum(d) / len(d) * 1e-6 if d else None
