"""``Input.frames`` steps the dataset on a reader thread, two frames ahead
(``frontend/input.py``).

The frames it yields equal, field by field and bit for bit, those of
``process_raw`` over the dataset stepped inline, on the rendered TUM
fixture (``utils/tum_fixture.py``) and on a small EuRoC stereo fixture with
IMU; a short ``SlamSystem`` session through it tracks the poses of a
session fed the inline frames.  The reader ends when the dataset does, when
it raises (raised on the consumer in that frame's place) and when the
generator is closed early, also while it waits on a full channel.  Its
``input.decode`` spans carry their frames' ids and its own thread; the
consumer's ``input.wait`` spans and ``input.frames`` /
``input.frames_ready`` counters add up, and a tracer ``reset()`` while a
reader span is open keeps ``records()`` consistent.  This file imports no
JAX.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from snakeslam_tpu_torch.frontend.datasets import (EurocDataset, RawFrame,
                                                   TumRgbdDataset)
from snakeslam_tpu_torch.frontend.input import Input
from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.utils import tum_fixture as TF

SMALL = dict(fd_features=500, fd_levels=2, width=320, height=240,
             fx=TF.FR1["fx"] / 2, fy=TF.FR1["fy"] / 2, cx=TF.FR1["cx"] / 2,
             cy=TF.FR1["cy"] / 2, max_keyframes=256, max_points=32768,
             feature_slots=512, local_map_slots=2048, lba_cam_slots=16,
             lba_point_slots=2048, lba_obs_slots=8)
N_TUM = 12


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _readers():
    return [t for t in threading.enumerate() if t.name == "input-reader"]


def _assert_frames_equal(a, b):
    """Every field of two ``FrameData``, arrays by dtype, shape and bytes."""
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), f.name
            assert (x.dtype, x.shape) == (y.dtype, y.shape), f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert type(x) is type(y) and x == y, f.name


def _inline(inp):
    """The frames of the dataset stepped inline, on this thread."""
    return [inp.process_raw(raw) for raw in inp.dataset]


def _tum_settings(root, name):
    s = Settings.from_ini(TF.copy_config(root / f"{name}.ini", **SMALL))
    s.set_default_parameters_for_dataset()
    return s


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    root = tmp_path_factory.mktemp("ahead")
    data = root / "data"
    TF.write_tum_fixture(data, TF.lane_world(scale=0.5),
                         TF.lane_trajectory(4 * N_TUM)[::4])
    return root, data


def _euroc(root, n=5):
    """A 320x240 EuRoC stereo sequence: a blocky texture, the right view
    shifted 4 px, 20 Hz frames, 200 Hz IMU."""
    rng = np.random.default_rng(3)
    tex = np.full((240, 400), 120, np.uint8)
    for _ in range(150):
        h, w = rng.integers(6, 30, 2)
        y, x = rng.integers(0, 240 - h), rng.integers(0, 400 - w)
        tex[y:y + h, x:x + w] = rng.choice([30, 80, 160, 230])
    mav = root / "mav0"
    t0 = 1403636579763555584
    for cam, shift in (("cam0", 0), ("cam1", 4)):
        (mav / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(n):
            ts = t0 + i * 50_000_000
            x = 8 + 3 * i + shift
            Image.fromarray(np.ascontiguousarray(tex[:, x:x + 320])).save(
                mav / cam / "data" / f"{ts}.png")
            lines.append(f"{ts},{ts}.png")
        (mav / cam / "data.csv").write_text("\n".join(lines))
    (mav / "cam0" / "sensor.yaml").write_text(
        "intrinsics: [458.654, 457.296, 160.0, 120.0]\n"
        "resolution: [320, 240]\n")
    (mav / "imu0").mkdir(parents=True)
    imu = ["#ts,wx,wy,wz,ax,ay,az"]
    for k in range(10 * n):
        imu.append(f"{t0 + k * 5_000_000},{0.01 * k},0.0,-0.02,0.1,0.0,9.81")
    (mav / "imu0" / "data.csv").write_text("\n".join(imu))


def test_tum_frames_equal_the_inline_steps(tum):
    root, data = tum
    s = _tum_settings(root, "frames")
    inline = _inline(Input(s, dataset_root=str(data), device="cpu"))
    ahead = list(Input(s, dataset_root=str(data), device="cpu").frames())
    assert len(ahead) == len(inline) == N_TUM
    for a, b in zip(ahead, inline):
        _assert_frames_equal(a, b)
        assert a.n > 0 and (a.depth > 0).any()
    assert _readers() == []


def test_euroc_stereo_frames_equal_the_inline_steps(tmp_path):
    _euroc(tmp_path)
    s = Settings()
    s.input_type = InputType.Stereo
    s.bf = 40.0
    s.fd_features = 300
    s.fd_levels = 2
    inline = _inline(Input(s, dataset=EurocDataset(tmp_path, stereo=True),
                           device="cpu"))
    ahead = list(Input(s, dataset=EurocDataset(tmp_path, stereo=True),
                       device="cpu"))
    assert len(ahead) == len(inline) == 5
    for a, b in zip(ahead, inline):
        _assert_frames_equal(a, b)
        assert a.n > 0 and (a.right >= 0).any()
    assert [a.imu_omega is None for a in ahead] == [True] + [False] * 4
    assert _readers() == []


def test_session_poses_equal_a_session_of_inline_frames(tum):
    from snakeslam_tpu_torch.system.slam import SlamSystem

    root, data = tum
    poses = []
    for ahead in (True, False):
        s = _tum_settings(root, f"session_{ahead}")
        inp = Input(s, dataset_root=str(data), device="cpu")
        system = SlamSystem(s, "cpu")
        system.run(iter(inp) if ahead else _inline(inp))
        poses.append([(f.frame_id, f.pose_cw)
                      for f in system.tracker.trajectory])
    a, b = poses
    assert [i for i, _ in a] == [i for i, _ in b] == list(range(N_TUM))
    assert sum(p is not None for _, p in a) >= N_TUM - 1
    for (_, x), (_, y) in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.tobytes() == y.tobytes()


def _light_input(source):
    """An ``Input`` over ``source`` whose per-frame stages pass the raw
    frame through: the reader and its channel alone."""
    s = Settings()
    s.input_type = InputType.Mono
    inp = Input(s, dataset=source, device="cpu")
    inp.process_raw = lambda raw: raw
    return inp


def _raw(i):
    return RawFrame(frame_id=i, timestamp=0.1 * i,
                    gray=np.zeros((8, 8), np.uint8))


def test_closing_early_stops_the_reader_on_a_full_channel():
    asked = []

    def source():
        for i in range(100):
            asked.append(i)
            yield _raw(i)

    frames = _light_input(source()).frames()
    assert [next(frames).frame_id for _ in range(2)] == [0, 1]
    (reader,) = _readers()
    # frames 2 and 3 fill the channel; the reader holds 4, blocked
    deadline = time.monotonic() + 10
    while len(asked) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)
    assert asked == [0, 1, 2, 3, 4] and reader.is_alive()
    t0 = time.monotonic()
    frames.close()
    assert time.monotonic() - t0 < 1.0
    assert not reader.is_alive() and _readers() == []


def test_ends_with_the_dataset():
    frames = list(_light_input(_raw(i) for i in range(7)))
    assert [f.frame_id for f in frames] == list(range(7))
    assert _readers() == []


def test_a_failing_step_raises_on_the_consumer_after_its_frames():
    def source():
        for i in range(3):
            yield _raw(i)
        raise ValueError("frame 3 unreadable")

    got = []
    with pytest.raises(ValueError, match="frame 3 unreadable"):
        for frame in _light_input(source()):
            got.append(frame.frame_id)
    assert got == [0, 1, 2]
    assert _readers() == []


def test_spans_and_counters_of_the_reader_and_the_consumer():
    """Frame 0 is held back until the consumer waits on it; every later
    frame is taken only once the reader has moved past it, so it waits
    in the channel."""
    n = 6
    asked = [threading.Event() for _ in range(n + 1)]
    release = threading.Timer(0.5, asked[0].set)

    def source():
        asked[0].wait(10)
        for i in range(n):
            if i:
                asked[i].set()
            yield _raw(i)
        asked[n].set()

    tracer.enable()
    release.start()
    frames = _light_input(source()).frames()
    got = [next(frames).frame_id]
    for i in range(1, n):
        assert asked[i + 1].wait(10)
        got.append(next(frames).frame_id)
    assert list(frames) == [] and got == list(range(n))
    tracer.disable()
    release.join(10)
    recs = tracer.records()
    me = threading.get_ident()
    decode = [r for r in recs if r.name == "input.decode"]
    wait = [r for r in recs if r.name == "input.wait"]
    # one step per frame and the step that ends the dataset
    assert [r.frame_id for r in decode] == list(range(n)) + [None]
    assert [r.frame_id for r in wait] == list(range(n)) + [None]
    assert len({r.thread for r in decode}) == 1 and decode[0].thread != me
    assert {r.thread for r in wait} == {me}
    assert all(r.parent == -1 and r.t0 <= r.t1 for r in decode + wait)
    # frame 0's take waited out its whole decode
    assert wait[0].t0 < decode[0].t1 <= wait[0].t1
    assert tracer.counters() == {"input.frames": n,
                                 "input.frames_ready": n - 1}


def _consistent(recs):
    for i, r in enumerate(recs):
        assert r.t1 is not None and r.t0 <= r.t1
        if r.parent >= 0:
            p = recs[r.parent]
            assert r.parent < i and p.thread == r.thread
            assert p.t0 <= r.t0 and r.t1 <= p.t1


def test_a_reset_while_a_reader_span_is_open_keeps_records_consistent():
    """The window's switch resets the tracer with the reader running: the
    step open at the reset is dropped, and a span the dataset opens inside
    it afterwards is recorded at the top."""
    inside = threading.Event()
    go_on = threading.Event()

    def source():
        for i in range(5):
            if i == 2:
                inside.set()
                go_on.wait(10)
            with tracer.span("test.read", i):
                pass
            yield _raw(i)

    tracer.enable()
    frames = _light_input(source()).frames()
    assert next(frames).frame_id == 0
    assert inside.wait(10)
    tracer.reset()
    go_on.set()
    assert [f.frame_id for f in frames] == [1, 2, 3, 4]
    tracer.disable()
    recs = tracer.records()
    _consistent(recs)
    by = {(r.name, r.frame_id): r for r in recs}
    assert by[("test.read", 2)].parent == -1
    assert ("input.decode", 2) not in by
    parent = by[("test.read", 3)].parent
    assert recs[parent][:1] == ("input.decode",)
    assert recs[parent].frame_id == 3
    assert [r.frame_id for r in recs if r.name == "input.decode"] == [
        3, 4, None]
    assert tracer.counters()["input.frames"] == 4


def test_a_reset_under_an_open_span_of_any_thread():
    """The tracer alone: a child opened after a reset under a parent
    opened before it is recorded at the top, on the main thread too."""
    tracer.enable()
    with tracer.span("outer", 1):
        tracer.reset()
        with tracer.span("inner"):
            with tracer.span("leaf"):
                pass
    recs = tracer.records()
    assert [(r.name, r.parent, r.frame_id) for r in recs] == [
        ("inner", -1, 1), ("leaf", 0, 1)]
    _consistent(recs)
