"""Windowed runner (tracking/windowed.py): the share of window frames
dispatched and never consumed, in the sessions that finished (the session
cut at the window's close would count its windows in flight); moves
fps."""

PROBES = []


def read(ctx):
    done = {m.session for m in ctx.rec.maps}
    n_disp = sum(ctx.rec.session_dispatched.get(s, 0) for s in done)
    n_cons = sum(ctx.rec.session_consumed.get(s, 0) for s in done)
    return 100.0 * (n_disp - n_cons) / n_disp if n_disp else None
