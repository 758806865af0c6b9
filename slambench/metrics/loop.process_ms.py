"""Loop closing (loop/loop_closing.py, loop/keyframe_database.py,
ops/bow.py): LoopClosing.process's ms a keyframe, its corrections
included; moves fps."""

PROCESS = "snakeslam_tpu_torch.loop.loop_closing:LoopClosing.process"
PROBES = [PROCESS]


def read(ctx):
    p = ctx.probe(PROCESS)
    return p.seconds / p.calls * 1e3 if p.calls else None
