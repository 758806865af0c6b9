"""Dataset input (frontend/input.py, frontend/datasets.py): the reader
iterator's ms a frame, ORB's detect left out; moves fps."""

DETECT = "snakeslam_tpu_torch.frontend.feature_detector:FeatureDetector.detect"
PROBES = [DETECT]


def read(ctx):
    rec = ctx.rec
    if not rec.reads:
        return None
    return (rec.read_s - ctx.probe(DETECT).seconds) / rec.reads * 1e3
