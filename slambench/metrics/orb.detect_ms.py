"""ORB front-end (frontend/feature_detector.py, ops/orb.py):
FeatureDetector.detect's ms a frame; moves fps."""

DETECT = "snakeslam_tpu_torch.frontend.feature_detector:FeatureDetector.detect"
PROBES = [DETECT]


def read(ctx):
    p = ctx.probe(DETECT)
    return p.seconds / p.calls * 1e3 if p.calls else None
