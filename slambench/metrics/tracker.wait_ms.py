"""Per-frame tracker (tracking/tracker.py): the tracker.wait spans, the
host blocked on the coarse and fine steps' readbacks, in ms a frame
(tracker.frame span); moves fps."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    recs = P.spans() or []
    frames = P.durations_ns(recs, "tracker.frame")
    if not frames:
        return None
    return sum(P.durations_ns(recs, "tracker.wait")) / len(frames) * 1e-6
