"""Dataset input (frontend/input.py, frontend/datasets.py): the program's
input.decode span, the dataset's step (a frame's PNG colour and depth read
and decoded), in ms a frame; moves fps."""

import program_trace as P

PROBES = [P.SWITCH]


def read(ctx):
    recs = P.spans() or []
    d = [r.t1 - r.t0 for r in recs if r.name == "input.decode"
         and r.t1 is not None and r.frame_id is not None]
    return sum(d) / len(d) * 1e-6 if d else None
