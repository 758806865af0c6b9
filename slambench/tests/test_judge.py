"""The judge at a size a CPU test run holds: the program's answers pass
the cells' limits, the control (the reference in the program's place, in
bfloat16) fails them, and so does the timed path broken underneath in
each way the cells can break: a step that returns its state unchanged,
half of each frame's observations left out of its pose, a pose altered
where it is produced, an ORB descriptor altered where it is produced.
(No cell spans chips: no exchange between chips to leave out.)"""

import json

import numpy as np
import pytest
import torch

from harness import (HERE, Cell, Runner, cleanup, load_cell, run_window,
                     workdir_for)
from reference.judge import readings

WS = "snakeslam_tpu_torch.models.window_step"
TS = "snakeslam_tpu_torch.models.tracking_step"


# The windowed entry at test size: the EuRoC configuration (which no cell
# of the manifest runs yet) over chip_smoke.py's dense slice, 48 frames of
# an orbit arc's first 0.144 rad at 10 fps time stamps, a keyframe every
# few frames, so a session's map is judged after finalize.  Its limits are
# this size's, between the program's readings and the control's here.
WINDOWED = dict(generator="feature_frames", world_points=6000,
                trajectory="orbit", frames=48, arc_rad=0.144, radius_m=7.0,
                fps=10.0, noise_px=0.3, sequences=1, window=8,
                warmup=dict(sequence="own", frames=16, dense_fps=10.0),
                limits=dict(frame_excess_chi2=5.0, frame_excess_chi2_mean=0.1,
                            init_gap_mm=0.0, kf_gap_mm=0.1,
                            point_excess_chi2=0.05, kf_ate_mm=20.0))


def tiny(name):
    if name == "windowed":
        config = json.loads((HERE / "configs" / "euroc_stereo_vo.json")
                            .read_text())
        return Cell("euroc_stereo_vo.tiny", {"chips": 1}, config, WINDOWED,
                    [], [])
    c = load_cell(name)
    t = dict(c.traffic, frames=40, arc_rad=0.9 * 39 / 299,
             warmup=dict(sequence=0, frames=8), orb_check_frames=2)
    return Cell(c.name, c.entry, c.config, t, c.end_to_end, c.per_layer)


SEED = 2**31 + 99


def _truth(cell, seed=SEED):
    """The tiny cell's true camera centres, made anew from its seed."""
    from harness import make_sequences
    wd = workdir_for("truth")
    try:
        seqs, _ = make_sequences(cell, seed, wd)
        return [q.truth for q in seqs]
    finally:
        cleanup(wd)


def run_tiny(name, seconds, control=False, seed=SEED):
    """(cell, recorder, the program's readings, the control's or None)."""
    torch.set_num_threads(2)
    cell = tiny(name)
    wd = workdir_for("test")
    try:
        r = Runner(cell, seed, "cpu", wd)
        rec = run_window(r, seconds)
        images = None
        if cell.traffic["generator"] == "tum_render":
            images = [str(r.seqs[0].root / n) for n in r.seqs[0].images]
        got = readings(rec, cell.config, images, truth=r.truth)
        low = (readings(rec, cell.config, images, dtype=torch.bfloat16,
                        truth=r.truth) if control else None)
        return cell, rec, got, low
    finally:
        cleanup(wd)


@pytest.fixture(scope="module")
def windowed():
    return run_tiny("windowed", 80, control=True)


@pytest.fixture(scope="module")
def per_frame():
    return run_tiny("tum_rgbd_fr1.orbit300", 20, control=True)


def over(got, limits):
    return {k: v for k, v in got.items()
            if k in limits and v is not None and v > limits[k]}


def test_program_within_limits_windowed(windowed):
    cell, rec, got, _ = windowed
    assert rec.maps, "no session finished: the map is not judged"
    lim = cell.traffic["limits"]
    assert all(got[k] is not None for k in lim), got
    assert not over(got, lim), got


def test_wrong_correction_fails_the_ate(windowed):
    """A map bent as a wrong loop correction bends it (the later half of
    its keyframes 0.5 m off) reads over the ATE's limit; the map as made
    does not."""
    import copy

    from reference.judge import measure
    cell, rec, got, _ = windowed
    bent = copy.deepcopy(rec)
    for m in bent.maps:
        half = np.arange(len(m.kf_ids)) >= len(m.kf_ids) // 2
        R, t = m.kf_pose[half, :3, :3], m.kf_pose[half, :3, 3]
        # the centre moves by +0.5 m in x: t' = t - R @ dx
        m.kf_pose[half, :3, 3] = t - R @ np.array([0.5, 0.0, 0.0])
    lim = cell.traffic["limits"]["kf_ate_mm"]
    assert got["kf_ate_mm"] <= lim
    ate = measure(bent, cell.config, truth=_truth(cell))["kf_ate_mm"]
    assert ate.max() > lim, ate


def test_control_fails_windowed(windowed):
    cell, _, _, low = windowed
    assert over(low, cell.traffic["limits"]), low


def test_program_within_limits_per_frame(per_frame):
    cell, _, got, _ = per_frame
    lim = cell.traffic["limits"]
    for k in ("frame_excess_chi2", "frame_excess_chi2_mean", "init_gap_mm",
              "orb_mismatch_pct"):
        assert got[k] is not None and got[k] <= lim[k], got


def test_control_fails_per_frame(per_frame):
    cell, _, _, low = per_frame
    lim = cell.traffic["limits"]
    assert low["frame_excess_chi2"] > lim["frame_excess_chi2"], low
    assert low["orb_mismatch_pct"] > lim["orb_mismatch_pct"], low


# -- the timed path broken underneath ---------------------------------------

def _unchanged(refine):
    def f(T0, obs, *a, **k):
        _, inlier, n = refine(T0, obs, *a, **k)
        return T0, inlier, n
    return f




def _reclassified(refine):
    """The pose of half the observations; the inliers of all of them at
    that pose (what the frame then reports)."""
    def f(T0, obs, cam, bf, *a, **k):
        idx = torch.arange(obs.mask.shape[-1])
        T, _, _ = refine(T0, obs._replace(mask=obs.mask & (idx % 2 == 0)),
                         cam, bf, *a, **k)
        _, inlier, n = refine(T, obs, cam, bf, *a,
                              **dict(k, outer_iters=1, inner_iters=0))
        return T, inlier, n
    return f


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_fail_windowed(monkeypatch, fault):
    import importlib

    ws = importlib.import_module(WS)
    if fault == "unchanged":
        monkeypatch.setattr(ws, "robust_pose_refine",
                            _unchanged(ws.robust_pose_refine))
    elif fault == "half":
        monkeypatch.setattr(ws, "robust_pose_refine",
                            _reclassified(ws.robust_pose_refine))
    else:
        from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
        inner = WindowedRunner._consume

        def consume(self, item, outs, *a):
            outs = outs.copy()
            outs[:, 3] += 1e-2          # every pose 1 cm off where made
            return inner(self, item, outs, *a)
        monkeypatch.setattr(WindowedRunner, "_consume", consume)
    cell, _, got, _ = run_tiny("windowed", 12)
    assert over(got, cell.traffic["limits"]), got


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "orb"])
def test_faults_fail_per_frame(monkeypatch, fault):
    import importlib

    ts = importlib.import_module(TS)
    if fault == "unchanged":
        monkeypatch.setattr(ts, "robust_pose_refine",
                            _unchanged(ts.robust_pose_refine))
    elif fault == "half":
        monkeypatch.setattr(ts, "robust_pose_refine",
                            _reclassified(ts.robust_pose_refine))
    elif fault == "altered":
        from snakeslam_tpu_torch.tracking.tracker import Tracker
        inner = Tracker._track

        def track(self, frame, *a, **k):
            ok = inner(self, frame, *a, **k)
            if ok:
                frame.pose_cw = frame.pose_cw.copy()
                frame.pose_cw[0, 3] += 1e-2
            return ok
        monkeypatch.setattr(Tracker, "_track", track)
    else:
        from snakeslam_tpu_torch.frontend.feature_detector import (
            FeatureDetector)
        inner = FeatureDetector.detect

        def detect(self, *a, **k):
            f = inner(self, *a, **k)
            f.descriptors = f.descriptors.copy()
            f.descriptors[0, 0] ^= np.uint8(1)
            return f
        monkeypatch.setattr(FeatureDetector, "detect", detect)
    cell, _, got, _ = run_tiny("tum_rgbd_fr1.orbit300", 8)
    assert over(got, cell.traffic["limits"]), got


def test_unlisted_init_gap_never_reads_depth():
    """A monocular session's init frame carries no depth: a cell that does
    not list ``init_gap_mm`` is judged without reaching it, and only by
    the numbers it lists; listing it reaches the depth."""
    from types import SimpleNamespace

    from harness import FrameRec

    class NoDepth:
        def __getitem__(self, key):
            raise AssertionError("the init frame's depth was read")

    n = 12
    init = FrameRec(0, 0, 0.0, np.eye(4), np.zeros((n, 2)),
                    -np.ones(n), np.zeros(n, np.int32),
                    np.zeros((n, 3)), kind="init", depth=NoDepth())
    rec = SimpleNamespace(frames=[init], maps=[])
    config = load_cell("tum_rgbd_fr1.orbit300").config
    listed = ["frame_excess_chi2", "frame_excess_chi2_mean", "kf_gap_mm"]
    got = readings(rec, config, numbers=listed)
    assert got == dict.fromkeys(listed)
    with pytest.raises(AssertionError, match="depth was read"):
        readings(rec, config, numbers=listed + ["init_gap_mm"])
