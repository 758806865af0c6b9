"""Kernel csrc/pose_refine.cu (ops/pose_fused.py): the window's launches'
least time over their device time, in %.  Each launch's least time is the
larger of its bytes at the HBM rate and its float32 operations at the
card's rate outside the tensor cores, counted by the frozen roofline
arithmetic at the launch's own batch, slots and GN schedule (the launch
tally); the device time is the trace's.  Moves fps."""

from reference.roofline import pose_bound_s

PROBES = []
KERNEL = "pose_refine_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    dev = sum(s for n, (s, _) in ctx.trace["ops"].items() if KERNEL in n)
    least = sum(c * pose_bound_s(N, o, i, B)[0]
                for (B, N, o, i), c in ctx.launches[0].items())
    return 100.0 * least / dev if dev > 0 and least > 0 else None
