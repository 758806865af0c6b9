"""The judge at a size a CPU test run holds: the program's answers pass
the cells' limits, the control (the reference in the program's place, in
bfloat16) fails them, and so does the timed path broken underneath in
each way the cells can break: a step that returns its state unchanged,
half of each frame's observations left out of its pose, a pose altered
where it is produced, an ORB descriptor altered where it is produced.
(No cell spans chips: no exchange between chips to leave out.)"""

import contextlib
import copy
import json

import numpy as np
import pytest
import torch

from harness import (HERE, Cell, Runner, cleanup, judge_in_flight,
                     load_cell, run_window, workdir_for)
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
    rec = SimpleNamespace(frames=[init], maps=[],
                          cameras={0: (517.3, 516.5, 318.6, 255.3, 40.0)})
    config = load_cell("tum_rgbd_fr1.orbit300").config
    listed = ["frame_excess_chi2", "frame_excess_chi2_mean", "kf_gap_mm"]
    got = readings(rec, config, numbers=listed)
    assert got == dict.fromkeys(listed)
    with pytest.raises(AssertionError, match="depth was read"):
        readings(rec, config, numbers=listed + ["init_gap_mm"])


@pytest.mark.parametrize("run", ["windowed", "per_frame"])
def test_no_imu_reads_as_the_visual_problems(request, run):
    """A run with no IMU carries no prior on its frames and no constraint
    on its maps, and its readings are, bit for bit, those of the visual
    problems alone: the problems the judge solved before it had IMU
    terms.  The control's too."""
    cell, rec, got, low = request.getfixturevalue(run)
    assert all(f.prior is None for f in rec.frames)
    assert all(m.rpc == [] for m in rec.maps)
    truth = _truth(cell) if run == "windowed" else None
    names = [n for n in got if n not in ("orb_mismatch_pct", "loops_missed")]
    for dtype, want in ((torch.float64, got), (torch.bfloat16, low)):
        for imu in (True, False):
            again = readings(rec, cell.config, dtype=dtype, truth=truth,
                             numbers=names, imu=imu)
            assert again == {n: want[n] for n in names}, (dtype, imu)


@contextlib.contextmanager
def closing_after(n: int | None = None):
    """The window closes once ``n`` frames are recorded or, with no ``n``,
    once the first session's map is, whatever the clock says (a session on
    this CPU takes tens of seconds)."""
    from harness import Recorder
    name = "frame_extra" if n else "keep_map"
    inner = getattr(Recorder, name)

    def hook(self, *a):
        if not n or len(self.frames) + 1 >= n:
            self.deadline = float("-inf")
        return inner(self, *a)
    setattr(Recorder, name, hook)
    try:
        yield
    finally:
        setattr(Recorder, name, inner)


@pytest.mark.parametrize("name, frames", [("windowed", 16),
                                          ("tum_rgbd_fr1.orbit300", 24)])
def test_a_window_shorter_than_a_session_is_judged(name, frames):
    """A per-frame window that finishes no session ends with one map, that
    of the session in flight, finalized after the window for the judge;
    the frames it recorded, and so ``fps``'s count over the window's
    seconds, are those the window closed with.  The windowed entry's
    session in flight, stopped inside a window of frames, is not
    finalized: no map, and the frames and figures as they were."""
    import dataclasses

    import run as RUN
    from harness import load_manifest

    torch.set_num_threads(2)
    e2e = [m for m in load_manifest()["end_to_end"]
           if m["name"] in ("fps", "setup_s")]
    cell = dataclasses.replace(tiny(name), end_to_end=e2e)
    windowed = name == "windowed"
    seconds = 600.0
    wd = workdir_for("in-flight")
    try:
        r = Runner(cell, SEED + 1, "cpu", wd)
        with closing_after(frames):
            rec = run_window(r, seconds)
        assert rec.sessions_done == 0 and rec.maps == []
        assert (r.in_flight is None) == windowed
        before = [(f.frame_id, f.kind, f.pose) for f in rec.frames]
        assert len(rec.frames) == frames
        metrics = RUN.end_to_end(cell, rec, seconds, 1.0)
        assert judge_in_flight(r, rec) != windowed and r.in_flight is None
        assert not judge_in_flight(r, rec)
        assert [(f.frame_id, f.kind, f.pose) for f in rec.frames] == before
        assert RUN.end_to_end(cell, rec, seconds, 1.0) == metrics
        assert len(rec.maps) == (0 if windowed else 1)
        assert all(m.session == 0 for m in rec.maps)
    finally:
        cleanup(wd)


def test_a_finished_session_leaves_nothing_in_flight(windowed):
    """Where a session finished, the one in flight at the close is dropped
    as before: the maps judged are the finished sessions' alone."""
    _, rec, _, _ = windowed
    assert rec.sessions_done >= 1 and len(rec.maps) == rec.sessions_done


def test_dataset_calibration_reaches_tracker_and_judge(monkeypatch):
    """A per-frame cell whose dataset gives its own intrinsics (as EuRoC's
    sensor.yaml and KITTI's calib.txt do), other than its INI's: the
    system is built after the ``Input``, so the tracker's camera is the
    dataset's, and the judge solves with the camera the session's system
    was built with."""
    import reference.judge as J
    from snakeslam_tpu_torch.frontend import datasets as DS
    from snakeslam_tpu_torch.system.slam import SlamSystem

    calib = dict(fx=520.5, fy=515.25, cx=320.5, cy=250.75, bf=41.5)
    want = tuple(calib[k] for k in ("fx", "fy", "cx", "cy", "bf"))
    init = DS.TumRgbdDataset.__init__

    def with_calib(self, *a, **k):
        init(self, *a, **k)
        self.calib = dict(calib)
    monkeypatch.setattr(DS.TumRgbdDataset, "__init__", with_calib)
    systems = []
    build = SlamSystem.__init__

    def kept(self, *a, **k):
        build(self, *a, **k)
        systems.append(self)
    monkeypatch.setattr(SlamSystem, "__init__", kept)
    solved = []
    gaps = J._pose_gaps

    def seen(T, pts, uv, right, octv, cam, bf, *a, **k):
        solved.append((tuple(cam), bf))
        return gaps(T, pts, uv, right, octv, cam, bf, *a, **k)
    monkeypatch.setattr(J, "_pose_gaps", seen)

    torch.set_num_threads(2)
    cell = tiny("tum_rgbd_fr1.orbit300")
    ini = cell.config["ini"]["Camera"]
    assert all(ini[k] != v for k, v in calib.items())
    wd = workdir_for("calib")
    try:
        r = Runner(cell, SEED, "cpu", wd)
        with closing_after(6):
            rec = run_window(r, 600.0)
    finally:
        cleanup(wd)
    assert len(systems) == 1
    t = systems[0].tracker
    assert tuple(float(x) for x in (t.cam.fx, t.cam.fy, t.cam.cx, t.cam.cy,
                                    t.bf)) == want
    assert rec.cameras == {0: want}
    got = readings(rec, cell.config, numbers=["frame_excess_chi2"])
    assert got["frame_excess_chi2"] is not None
    assert solved and set(solved) == {(want[:4], want[4])}


def test_rotation_terms_linearize_exactly():
    """The judge's IMU terms: r = log(A R B) and its Jacobian under
    R <- exp(w) R, against central differences in float64."""
    from reference import geometry as G

    g = torch.Generator().manual_seed(7)
    rot = lambda *s: G.se3_exp(torch.cat(
        [torch.zeros(*s, 3), torch.rand(*s, 3, generator=g) * 2 - 1], -1)
        .double())[0]
    R, A, B = rot(5), rot(5, 2), rot(5, 2)
    r, J = G.rotation_terms(R, A, B)
    assert torch.allclose(G.se3_exp(torch.cat([torch.zeros_like(r), r], -1))
                          [0], A @ R[:, None] @ B, atol=1e-12)
    h = 1e-6
    for k in range(3):
        e = torch.zeros(6, dtype=torch.float64)
        e[3 + k] = h
        Rp, Rm = G.se3_exp(e)[0] @ R, G.se3_exp(-e)[0] @ R
        fd = (G.rotation_terms(Rp, A, B)[0]
              - G.rotation_terms(Rm, A, B)[0]) / (2 * h)
        assert torch.allclose(J[..., k], fd, atol=1e-8), k


def test_a_translation_weight_is_refused():
    """The judge holds the program's IMU terms as rotations alone: a prior
    or a constraint that weighs translation stops the run, where the
    judge would read it wrong."""
    from harness import _read_prior
    assert _read_prior(torch.eye(4), torch.tensor(0.0), 0.0) is None
    pose, w = _read_prior(torch.eye(4), torch.tensor(2.5), 0.0)
    assert w == 2.5 and pose.dtype == np.float64
    with pytest.raises(ValueError, match="translation weight"):
        _read_prior(torch.eye(4), 2.5, torch.tensor(1e-3))


# -- an inertial run ----------------------------------------------------------

GEN = "_scratch_mono_vi"          # the inertial cell's generator, a file
GEN_SOURCE = '''"""Monocular feature-level frames with IMU samples at 200 Hz: the
program's mono-VI lane (an excited orbit in a synthetic world, gyro bias
and noise), each session's world from its seed."""
from __future__ import annotations

from traffic.sequence import Sequence, true_centres


def sequences(cell, seeds, workdir):
    from snakeslam_tpu_torch.utils import vi_problems as VP
    from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld

    t = cell.traffic

    def frames(seed, n):
        world = SyntheticWorld(n_points=t["world_points"], seed=seed)
        return VP.lane_frames(VP.lane_settings(world), world, n, t["fps"])

    seqs = []
    for s in seeds[:-1]:
        raw = frames(s, t["frames"])
        seqs.append(Sequence(raw=raw, frames=len(raw),
                             truth=true_centres(raw)))
    warm = frames(seeds[-1], t["warmup"]["frames"])
    return seqs, Sequence(raw=warm, frames=len(warm))
'''
# euroc.ini (monocular, enable_imu) over the synthetic world's EuRoC camera,
# per frame; its gyro weights raised from 0.2 and 1000 so that the IMU's
# terms move the optima by more than the program's own rounding does
INERTIAL_WEIGHTS = dict(weight_gyro_tracking=2e5,
                        weight_gyro_optimization=1e5)
INERTIAL = dict(generator=GEN, world_points=3000, frames=64, fps=10.0,
                sequences=1, warmup=dict(frames=4),
                limits=dict(frame_excess_chi2=5.0, frame_excess_chi2_mean=0.1,
                            kf_gap_mm=0.1, point_excess_chi2=0.05))


def inertial_cell():
    config = json.loads((HERE / "configs" / "euroc_stereo_vo.json")
                        .read_text())
    ini = config["ini"]
    config.update(name=GEN, entry="per_frame",
                  settings={"pin_local_map_bucket": False})
    ini["Input"]["input_type"] = 0
    ini["IMU"].update(enable_imu=True, **INERTIAL_WEIGHTS)
    ini["Capacity"].update(local_map_slots=2048, lba_cam_slots=24,
                           lba_point_slots=4096, lba_obs_slots=8)
    return Cell(GEN + ".tiny", {"chips": 1}, config, INERTIAL, [], [])


@pytest.fixture(scope="module")
def inertial():
    """One session of 64 monocular frames with IMU samples at 200 Hz (the
    program's mono-VI lane: an excited orbit, gyro bias and noise) through
    the per-frame tracker: the gyro stage is reached near frame 45, the
    frames after it are refined with the gyro rotation prior, and
    ``finalize``'s global BA holds the IMU solver's relative-rotation
    constraints.  (cell, recorder, readings with the IMU's terms, without
    them, the control's.)"""
    torch.set_num_threads(2)
    path = HERE / "traffic" / f"{GEN}.py"
    cell = inertial_cell()
    numbers = list(INERTIAL["limits"])
    wd = workdir_for("inertial")
    try:
        path.write_text(GEN_SOURCE)
        r = Runner(cell, SEED, "cpu", wd)
        with closing_after():
            rec = run_window(r, 600.0)
        assert rec.sessions_done == 1
        got = readings(rec, cell.config, numbers=numbers)
        visual = readings(rec, cell.config, numbers=numbers, imu=False)
        low = readings(rec, cell.config, dtype=torch.bfloat16,
                       numbers=numbers)
        return cell, rec, got, visual, low
    finally:
        path.unlink(missing_ok=True)
        cleanup(wd)


def test_an_in_flight_map_reads_within_limits():
    """The inertial session closed at frame 52 of 64, past the gyro stage,
    and finalized in flight for the judge: its map (a few keyframes, with
    the IMU solver's constraints) and frames read within every limit,
    each number read; the control's read over each."""
    torch.set_num_threads(2)
    path = HERE / "traffic" / f"{GEN}.py"
    cell = inertial_cell()
    lim = cell.traffic["limits"]
    wd = workdir_for("in-flight-imu")
    try:
        path.write_text(GEN_SOURCE)
        r = Runner(cell, SEED + 2, "cpu", wd)
        with closing_after(52):
            rec = run_window(r, 600.0)
        assert rec.sessions_done == 0 and judge_in_flight(r, rec)
        assert len(rec.maps) == 1 and len(rec.maps[0].rpc) >= 2
        got = readings(rec, cell.config, numbers=list(lim))
        low = readings(rec, cell.config, dtype=torch.bfloat16,
                       numbers=list(lim))
    finally:
        path.unlink(missing_ok=True)
        cleanup(wd)
    assert None not in got.values() and not over(got, lim), got
    assert set(over(low, lim)) == set(lim), low


def test_inertial_run_holds_imu_terms(inertial):
    cell, rec, _, _, _ = inertial
    w = cell.config["ini"]["IMU"]["weight_gyro_tracking"]
    priors = [f.prior for f in rec.frames if f.prior is not None]
    assert len(priors) >= 5
    # w_rot = weight / dt at 10 fps
    for _, wp in priors:
        assert np.isclose(wp, w / 0.1, rtol=1e-3), wp
    m = rec.maps[0]
    assert len(m.rpc) >= 2 and len(m.kf_ids) >= 3
    for i, j, M, wp in m.rpc:
        assert 0 <= i < len(m.kf_ids) and 0 <= j < len(m.kf_ids)
        assert wp > 0 and M.shape == (4, 4)


def test_program_within_limits_inertial(inertial):
    cell, _, got, _, _ = inertial
    lim = cell.traffic["limits"]
    assert all(got[k] is not None for k in lim), got
    assert not over(got, lim), got


def test_inertial_visual_problems_alone_read_more(inertial):
    """The program's frames and keyframes sit at the optima of the
    problems it solves, IMU terms in: read without them, the same run's
    excess is larger."""
    _, _, got, visual, _ = inertial
    assert visual["kf_gap_mm"] > 3 * got["kf_gap_mm"], (got, visual)
    assert (visual["frame_excess_chi2_mean"]
            > 3 * got["frame_excess_chi2_mean"]), (got, visual)


def test_control_fails_inertial(inertial):
    cell, _, _, _, low = inertial
    lim = cell.traffic["limits"]
    assert low["frame_excess_chi2"] > lim["frame_excess_chi2"], low
    assert low["kf_gap_mm"] > lim["kf_gap_mm"], low


def _rotated(T, degrees):
    """T turned about its camera's x axis by ``degrees`` (centre kept)."""
    a = np.radians(degrees)
    R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]])
    out = T.copy()
    out[:3] = R @ T[:3]
    return out


@pytest.mark.parametrize("fault", ["keyframe_1cm", "frame_half_degree"])
def test_faults_fail_inertial(inertial, fault):
    """One keyframe moved 1 cm, or one gyro-held frame's pose turned
    0.5 degrees, after the run: each reads over its limit."""
    cell, rec, _, _, _ = inertial
    bad = copy.deepcopy(rec)
    if fault == "keyframe_1cm":
        m = bad.maps[0]
        R, t = m.kf_pose[1, :3, :3], m.kf_pose[1, :3, 3]
        m.kf_pose[1, :3, 3] = t - R @ np.array([0.01, 0.0, 0.0])
        name = "kf_gap_mm"
    else:
        f = next(f for f in bad.frames if f.prior is not None)
        f.pose = _rotated(f.pose, 0.5)
        name = "frame_excess_chi2"
    got = readings(bad, cell.config, numbers=[name])
    assert got[name] > cell.traffic["limits"][name], got
