"""Keyframe cycle on the windowed path (mapping/local_mapping.py,
optim/lba.py, mapping/fusion.py): LocalMapper.commit_deferred's ms a call,
loop closing's process (a back-end the commit feeds, its own layer) left
out; moves fps."""

COMMIT = "snakeslam_tpu_torch.mapping.local_mapping:LocalMapper.commit_deferred"
LOOP = "snakeslam_tpu_torch.loop.loop_closing:LoopClosing.process"
PROBES = [COMMIT, LOOP]


def read(ctx):
    p = ctx.probe(COMMIT)
    if not p.calls:
        return None
    return (p.seconds - ctx.probe(LOOP).seconds) / p.calls * 1e3
