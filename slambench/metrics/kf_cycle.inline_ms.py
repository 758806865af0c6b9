"""Keyframe cycle on the per-frame path (mapping/local_mapping.py):
LocalMapper.process_deferred's ms a call (triangulation, fusion, local BA
and the commit, loop closing's detection included); moves frame_ms_p95."""

CYCLE = "snakeslam_tpu_torch.mapping.local_mapping:LocalMapper.process_deferred"
PROBES = [CYCLE]


def read(ctx):
    p = ctx.probe(CYCLE)
    return p.seconds / p.calls * 1e3 if p.calls else None
