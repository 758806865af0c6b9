"""The port's tracer (``snakeslam_tpu_torch/system/stats.py``).

Off, ``span`` hands out one shared no-op (no clock read, no allocation)
and ``count`` does nothing.  On, spans nest by a per-thread stack, carry
their frame's id, and counters add.  A short CPU session over the rendered
TUM fixture (``utils/tum_fixture.py``, 320x240, 16 frames) records the
spans of every layer its path meets, each inside its parent, and tracks
the same poses, bit for bit, with the tracer on and off.  A graph capture
on the card records its span (``cuda``: skipped without a card).  This
file imports no JAX.
"""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from snakeslam_tpu_torch.system import stats as tracer
from snakeslam_tpu_torch.utils import tum_fixture as TF

SMALL = dict(fd_features=500, fd_levels=2, width=320, height=240,
             fx=TF.FR1["fx"] / 2, fy=TF.FR1["fy"] / 2, cx=TF.FR1["cx"] / 2,
             cy=TF.FR1["cy"] / 2, max_keyframes=256, max_points=32768,
             feature_slots=512, local_map_slots=2048, lba_cam_slots=16,
             lba_point_slots=2048, lba_obs_slots=8)

# every span and counter the per-frame RGB-D path meets on the CPU (graph
# captures are the card's)
SESSION_SPANS = {
    "input.decode", "input.wait", "orb.detect", "input.depth", "tracker.frame",
    "tracker.coarse_map", "tracker.coarse", "tracker.wait",
    "tracker.fine_map", "tracker.fine", "tracker.post",
    "tracker.kf_decision", "kf.insert", "kf_cycle.dispatch",
    "kf_cycle.wait", "kf_cycle.commit", "kf_cycle.backends", "finalize",
    "gba.full_ba", "gba.realign"}
SESSION_COUNTERS = {"tracker.frames", "tracker.fine_map_rebuilds",
                    "input.frames", "input.frames_ready"}


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(tracer, "_clock", lambda: next(it))


def test_off_hands_out_the_shared_noop_without_clock_or_allocation(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer worked while off")

    monkeypatch.setattr(tracer, "_clock", refuse)
    monkeypatch.setattr(tracer, "_Span", refuse)
    assert not tracer.enabled()
    assert tracer.span("a") is tracer.span("b", 3)
    only = [tracemalloc.Filter(True, tracer.__file__)]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(only)
        for _ in range(100):
            with tracer.span("tracker.frame", 7) as sp:
                sp.set_frame(8)
                tracer.count("tracker.frames")
                # what the span holds while it is open
                inside = tracemalloc.take_snapshot().filter_traces(only)
        after = tracemalloc.take_snapshot().filter_traces(only)
    finally:
        tracemalloc.stop()
    for snap in (inside, after):
        assert [d for d in snap.compare_to(before, "lineno")
                if d.size_diff > 0] == []
    assert tracer.records() == [] and tracer.counters() == {}


def test_nesting_sets_parent_and_frame(monkeypatch):
    _fake_clock(monkeypatch, range(100, 200, 10))
    tracer.enable()
    with tracer.span("outer", np.int64(7)):
        with tracer.span("mid"):
            with tracer.span("inner"):
                pass
        with tracer.span("other", 9):
            pass
    with tracer.span("late") as sp:
        sp.set_frame(11)
    r = tracer.records()
    assert [x.name for x in r] == ["outer", "mid", "inner", "other", "late"]
    assert [x.parent for x in r] == [-1, 0, 1, 0, -1]
    assert [x.frame_id for x in r] == [7, 7, 7, 9, 11]
    assert all(type(x.frame_id) is int for x in r)
    assert [(x.t0, x.t1) for x in r] == [(100, 170), (110, 140),
                                         (120, 130), (150, 160), (180, 190)]
    assert {x.thread for x in r} == {threading.get_ident()}


def test_threads_keep_their_own_stacks():
    tracer.enable()
    inside = threading.Barrier(2)
    done = threading.Barrier(2)

    def work(name):
        with tracer.span(name, 1 if name == "a" else 2):
            inside.wait()          # both outer spans open at once
            with tracer.span(name + ".child"):
                done.wait()

    ts = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    r = tracer.records()
    by = {x.name: (i, x) for i, x in enumerate(r)}
    for n, fid in (("a", 1), ("b", 2)):
        i, outer = by[n]
        _, child = by[n + ".child"]
        assert outer.parent == -1 and child.parent == i
        assert child.thread == outer.thread and child.frame_id == fid
    assert by["a"][1].thread != by["b"][1].thread


def test_many_threads_lose_no_record_or_count():
    """More threads than cores, switching every microsecond: every span
    and every count of every thread is kept, each child under its own
    thread's parent."""
    import sys

    n_threads, n_spans = 32, 300
    tracer.enable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with tracer.span("outer", k):
                    with tracer.span("inner"):
                        tracer.count("n")

        ts = [threading.Thread(target=work, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(switch)
    r = tracer.records()
    assert tracer.counters() == {"n": n_threads * n_spans}
    assert len(r) == 2 * n_threads * n_spans
    for x in r:
        if x.name == "inner":
            p = r[x.parent]
            assert p.name == "outer" and p.thread == x.thread
            assert p.frame_id == x.frame_id and p.t0 <= x.t0 <= x.t1 <= p.t1
        else:
            assert x.parent == -1


def test_counters_add_and_reset():
    tracer.enable()
    tracer.count("tracker.frames")
    tracer.count("tracker.frames", 4)
    tracer.count("tracker.fine_map_rebuilds")
    assert tracer.counters() == {"tracker.frames": 5,
                                 "tracker.fine_map_rebuilds": 1}
    tracer.reset()
    assert tracer.counters() == {} and tracer.records() == []


def test_a_span_open_at_disable_still_closes(monkeypatch):
    _fake_clock(monkeypatch, [1, 5])
    tracer.enable()
    with tracer.span("a"):
        tracer.disable()
        with tracer.span("b"):       # off: not recorded
            pass
    assert [tuple(x)[:3] for x in tracer.records()] == [("a", 1, 5)]


def test_table_lists_calls_mean_and_self(monkeypatch):
    _fake_clock(monkeypatch, [0, 1_000_000, 3_000_000, 4_000_000,
                              10_000_000, 11_000_000])
    tracer.enable()
    with tracer.span("tracker.frame"):
        with tracer.span("tracker.wait"):
            pass
    with tracer.span("tracker.frame"):
        pass
    tracer.count("tracker.frames", 2)
    lines = tracer.table().splitlines()
    assert lines[0].split() == ["Span", "Calls", "Mean", "(ms)", "Self",
                                "(ms)"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:]}
    # frames of 4 ms (a 2 ms wait inside) and 1 ms
    assert rows["tracker.frame"] == ["2", "2.500", "1.500"]
    assert rows["tracker.wait"] == ["1", "2.000", "2.000"]
    assert rows["tracker.frames"] == ["2"]


# ---------------------------------------------------------------------------
# a CPU session over the rendered TUM fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The fixture's 16 frames through ``SlamSystem.run(iter(Input))`` on
    the CPU, the tracer on and then off: (poses, records, counters) each,
    and the table of the run with the tracer on."""
    from snakeslam_tpu_torch.frontend.input import Input
    from snakeslam_tpu_torch.system.settings import Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem

    root = tmp_path_factory.mktemp("trace")
    data = root / "data"
    TF.write_tum_fixture(data, TF.lane_world(scale=0.5),
                         TF.lane_trajectory(64)[::4])
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for on in (True, False):
            s = Settings.from_ini(TF.copy_config(root / f"tum_{on}.ini",
                                                 **SMALL))
            s.set_default_parameters_for_dataset()
            tracer.reset()
            if on:
                tracer.enable()
            try:
                system = SlamSystem(s, "cpu")
                system.run(iter(Input(s, dataset_root=str(data),
                                      device="cpu")))
            finally:
                tracer.disable()
            poses = [(f.frame_id, f.pose_cw) for f in
                     system.tracker.trajectory]
            out[on] = (poses, tracer.records(), tracer.counters())
            if on:
                out["table"] = tracer.table()
    finally:
        torch.set_num_threads(n)
        tracer.reset()
    return out


def test_session_records_every_layer_it_meets(sessions):
    _, recs, counts = sessions[True]
    assert {r.name for r in recs} == SESSION_SPANS
    assert set(counts) == SESSION_COUNTERS
    assert counts["tracker.frames"] == 15        # the first initializes
    assert 1 <= counts["tracker.fine_map_rebuilds"] <= 15
    for r in recs:
        assert r.t1 is not None and r.t0 <= r.t1
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1
            assert p.thread == r.thread


def test_session_spans_of_a_frame_share_its_id(sessions):
    _, recs, _ = sessions[True]
    decoded = [r.frame_id for r in recs if r.name == "input.decode"]
    # one step per frame, and the step that ends the sequence
    assert decoded == list(range(16)) + [None]
    for name in ("orb.detect", "input.depth", "tracker.frame"):
        assert [r.frame_id for r in recs if r.name == name] == list(range(16))
    frames = {i: r.frame_id for i, r in enumerate(recs)
              if r.name == "tracker.frame"}
    for r in recs:
        top = r
        while top.parent >= 0:
            top = recs[top.parent]
        if top.name == "tracker.frame":
            assert r.frame_id == top.frame_id
    # a keyframe's cycle carries the frame that made it
    inserts = {r.frame_id for r in recs if r.name == "kf.insert"}
    cycles = {r.frame_id for r in recs if r.name.startswith("kf_cycle.")}
    assert cycles and cycles <= inserts <= set(frames.values())


def test_session_poses_equal_with_the_tracer_off(sessions):
    on, _, _ = sessions[True]
    off, recs, counts = sessions[False]
    assert recs == [] and counts == {}
    assert [i for i, _ in on] == [i for i, _ in off] and len(on) == 16
    for (_, a), (_, b) in zip(on, off):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)


def test_session_table_lists_its_spans(sessions):
    table = sessions["table"]
    rows = {ln.split()[0] for ln in table.splitlines()[1:]}
    assert rows == SESSION_SPANS | SESSION_COUNTERS


@pytest.mark.cuda
def test_a_graph_capture_records_its_span():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a graph capture has no CPU mode")
    from snakeslam_tpu_torch.utils import graphs

    prog = graphs.compiled(lambda x: x * 2 + 1, name="trace_test")
    x = torch.arange(8.0, device="cuda")
    tracer.enable()
    prog(x)            # met first: captured
    prog(x)            # replayed
    tracer.disable()
    caps = [r for r in tracer.records() if r.name == "graphs.capture"]
    assert len(caps) == 1 and caps[0].t0 < caps[0].t1
