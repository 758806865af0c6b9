"""Device (one H100): the share of the traced window in which no
operation ran on the card (torch.profiler's CUDA activity), in %; moves
fps."""

PROBES = []


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
