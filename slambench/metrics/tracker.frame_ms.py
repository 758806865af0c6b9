"""Per-frame tracker (tracking/tracker.py, models/tracking_step.py):
SlamSystem.process_frame's ms a frame with the inline keyframe cycle
(LocalMapper.process_deferred) left out; moves fps."""

FRAME = "snakeslam_tpu_torch.system.slam:SlamSystem.process_frame"
CYCLE = "snakeslam_tpu_torch.mapping.local_mapping:LocalMapper.process_deferred"
PROBES = [FRAME, CYCLE]


def read(ctx):
    p = ctx.probe(FRAME)
    if not p.calls:
        return None
    return (p.seconds - ctx.probe(CYCLE).seconds) / p.calls * 1e3
