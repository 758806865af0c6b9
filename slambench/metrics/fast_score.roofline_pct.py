"""Kernel csrc/fast_score.cu (ops/orb_kernels.py): the window's launches'
least time over their device time, in %, by the same rule as the pose
kernel's; FAST's bytes set its bound on any image (reference/roofline.py).
Moves fps."""

from reference.roofline import fast_bound_any_s

PROBES = []
KERNEL = "fast_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    dev = sum(s for n, (s, _) in ctx.trace["ops"].items() if KERNEL in n)
    least = sum(c * fast_bound_any_s(B * H * W)
                for (B, H, W), c in ctx.launches[1].items())
    return 100.0 * least / dev if dev > 0 and least > 0 else None
