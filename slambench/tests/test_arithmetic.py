"""The rate and percentile arithmetic takes every sample of the whole
window, and the frozen roofline counts equal chip_smoke.py's at the shapes
of PERF.md's kernel table."""

import numpy as np
import pytest

import run as RUN
from harness import Cell, FrameRec, Recorder
from reference import roofline as RF


def _cell(names):
    e2e = [{"name": n, "unit": "x"} for n in names]
    return Cell("c", {}, {}, {}, e2e, [])


def test_fps_counts_every_pose_out_over_the_whole_window():
    rec = Recorder(deadline=10.0)
    rng = np.random.default_rng(1)
    for i in range(997):
        pose = None if i % 50 == 0 else np.eye(4)
        rec.frames.append(FrameRec(i // 300, i, float(rng.uniform(0, 10)),
                                   pose))
    out = RUN.end_to_end(_cell(["fps"]), rec, 10.0, 1.0)
    assert out["fps"]["value"] == pytest.approx((997 - 20) / 10.0)


def test_p95_is_over_all_samples_not_chunks():
    rec = Recorder(deadline=10.0)
    rng = np.random.default_rng(2)
    # a tail that comes in one burst, as keyframe cycles bunch
    lat = np.concatenate([rng.uniform(20, 40, 900), rng.uniform(80, 200, 60),
                          rng.uniform(20, 40, 40)])
    for i, ms in enumerate(lat):
        rec.frames.append(FrameRec(0, i, 1.0 + ms / 1e3, np.eye(4),
                                   t_start=1.0))
    out = RUN.end_to_end(_cell(["frame_ms_p95"]), rec, 10.0, 1.0)
    assert out["frame_ms_p95"]["value"] == pytest.approx(
        np.percentile(lat, 95), rel=1e-9)
    # a median of per-chunk p95s differs: the tail sits in few chunks
    chunks = np.median([np.percentile(c, 95) for c in np.split(lat, 10)])
    assert abs(chunks - np.percentile(lat, 95)) > 1.0


# PERF.md's kernel table (chip_smoke.py, NVIDIA H100 80GB HBM3): pose
# N = 1024, B = 1, (2, 2): 0.018 us; loop realign B = 319 (4, 3): 17.0 us;
# FAST 64 x 480 x 752: 62.1 us (bytes); CLI 480 x 640: 0.83 us
POSE = [(1024, 2, 2, 1), (1024, 1, 3, 1), (1024, 4, 3, 319),
        (1024, 4, 3, 280), (512, 3, 3, 1)]


@pytest.mark.parametrize("n,outer,inner,batch", POSE)
def test_pose_bound_equals_chip_smoke(n, outer, inner, batch):
    import chip_smoke

    ms, by = chip_smoke.pose_bound(n, outer, inner, batch)
    s, by2 = RF.pose_bound_s(n, outer, inner, batch)
    assert s * 1e3 == pytest.approx(ms, rel=1e-12) and by == by2


def test_table_values():
    assert RF.pose_bound_s(1024, 2, 2, 1)[0] * 1e6 == pytest.approx(
        0.018, abs=5e-4)
    assert RF.pose_bound_s(1024, 4, 3, 319)[0] * 1e6 == pytest.approx(
        17.0, abs=0.05)
    assert RF.fast_bound_any_s(64 * 480 * 752) * 1e6 == pytest.approx(
        62.1, abs=0.05)
    assert RF.fast_bound_any_s(480 * 640) * 1e6 == pytest.approx(0.83,
                                                                 abs=0.01)


@pytest.mark.parametrize("shape", [(64, 480, 752), (1, 480, 640),
                                   (1, 400, 533), (3, 101, 157)])
def test_fast_bound_equals_chip_smoke_on_any_image(shape):
    import torch

    import chip_smoke

    g = torch.Generator().manual_seed(5)
    imgs = torch.rand(shape, generator=g) * 255
    ms, by, _ = chip_smoke.fast_bound(imgs, 20.0)
    assert by == "bytes"
    assert RF.fast_bound_any_s(imgs.numel()) * 1e3 == pytest.approx(
        ms, rel=1e-12)


def test_ate_after_a_similarity_is_the_residual_alone():
    import torch

    from reference.geometry import ate_mm
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(60, 3)) * 2.0
    a = rng.normal(size=3)
    R = torch.linalg.matrix_exp(torch.tensor(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])).numpy()
    est = 1.7 * gt @ R.T + np.array([0.3, -2.0, 5.0])
    assert ate_mm(torch.from_numpy(est), torch.from_numpy(gt)) < 1e-9
    # a bend no similarity takes out: half the points 0.1 m off along x
    bent = est.copy()
    bent[30:, 0] += 0.1
    assert 10.0 < ate_mm(torch.from_numpy(bent), torch.from_numpy(gt)) < 100.0
