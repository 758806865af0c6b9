"""Global BA / finalize (system/slam.py, optim/gba.py): SlamSystem.finalize's
seconds a session; moves fps."""

FINALIZE = "snakeslam_tpu_torch.system.slam:SlamSystem.finalize"
PROBES = [FINALIZE]


def read(ctx):
    p = ctx.probe(FINALIZE)
    return p.seconds / p.calls if p.calls else None
