"""Windowed runner (tracking/windowed.py): WindowedRunner._dispatch's ms a
window frame dispatched; moves fps."""

DISPATCH = "snakeslam_tpu_torch.tracking.windowed:WindowedRunner._dispatch"
PROBES = [DISPATCH]


def read(ctx):
    p = ctx.probe(DISPATCH)
    n = ctx.rec.dispatched
    return p.seconds / n * 1e3 if n else None
