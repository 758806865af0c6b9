"""Loop closing (ops/sim3_solver.py, ops/pgo.py): LoopClosing._correct_loop's
ms a correction (PGO, SearchAndFuse, the global BA, and the captures of
graphs met first); moves fps."""

CORRECT = "snakeslam_tpu_torch.loop.loop_closing:LoopClosing._correct_loop"
PROBES = [CORRECT]


def read(ctx):
    p = ctx.probe(CORRECT)
    return p.seconds / p.calls * 1e3 if p.calls else None
