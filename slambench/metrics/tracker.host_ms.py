"""Per-frame tracker (system/slam.py, tracking/tracker.py): per
tracker.frame span, its ms less the time of its tracker.wait (the
readbacks) and kf.insert (a keyframe's insertion and inline cycle)
descendants: the tracker's host work, in which the card can idle, a
frame; moves fps."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    recs = P.spans() or []
    d = P.less_descendants_ns(recs, "tracker.frame",
                              ("tracker.wait", "kf.insert"))
    return sum(d) / len(d) * 1e-6 if d else None
