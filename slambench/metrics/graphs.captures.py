"""Graph layer (utils/graphs.py): CUDA graphs captured inside the window
(a delta of graphs.stats()), a count; moves fps."""

PROBES = []


def read(ctx):
    return ctx.graph_captures
