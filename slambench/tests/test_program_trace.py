"""The program's own spans in the benchmark: the switch that has the
program's tracer on for the window, the readers of the six metrics it
feeds, and the idle split with the program's spans laid over the probes'."""

import pytest
from torch.autograd import DeviceType

import program_trace as P
import tracing as T
from harness import load_cell, load_manifest, load_reader
from probes import Probe, SpanLog
from snakeslam_tpu_torch.system import stats as tracer

NEW = {"input.decode_ms": ("dataset input", "program_span", "fps"),
       "tracker.host_ms": ("per-frame tracker", "program_span", "fps"),
       "tracker.wait_ms": ("per-frame tracker", "program_span", "fps"),
       "kf_cycle.wait_ms": ("keyframe cycle", "program_span",
                            "frame_ms_p95"),
       "graphs.capture_s": ("graph layer", "program_span", "fps"),
       "tracker.fine_rebuild_pct": ("per-frame tracker", "program_counter",
                                    "fps")}
CELL = "tum_rgbd_fr1.orbit300"


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def test_the_six_metrics_are_in_the_manifest_and_the_cell():
    by = {m["name"]: m for m in load_manifest()["per_layer"]}
    for name, (layer, source, moves) in NEW.items():
        m = by[name]
        assert (m["layer"], m["source"], m["moves"]) == (layer, source, moves)
        assert m["workloads"] == [CELL]
        assert P.SWITCH in load_reader(name).PROBES
    assert set(NEW) <= {m["name"] for m in load_cell(CELL).per_layer}


def test_the_switch_has_the_tracer_on_while_its_probe_is_installed():
    tracer.enable()
    with tracer.span("before the window"):
        pass
    tracer.disable()
    probe = Probe(P.SWITCH, SpanLog())
    probe.install()
    try:
        assert tracer.enabled() and tracer.records() == []
        with tracer.span("tracker.frame", 3):
            pass
    finally:
        probe.remove()
    assert not tracer.enabled()
    assert [r.name for r in P.spans()] == ["tracker.frame"]
    assert probe.calls == 0


def test_without_the_programs_tracer_the_readers_read_nothing(monkeypatch):
    monkeypatch.setattr(P, "tracer", lambda: None)
    probe = Probe(P.SWITCH, SpanLog())
    probe.install()
    probe.remove()
    assert P.spans() is None and P.counters() is None
    for name in NEW:
        assert load_reader(name).read(None) is None


def _window(monkeypatch):
    """Two frames of the tracker and a keyframe cycle on a fake clock (ns):

    frame 0: 0-10 ms, waits 2-3 and 6-8, its post 8-9;
    frame 1: 20-40 ms, wait 22-24, kf.insert 30-39 (kf_cycle.wait 31-33
    inside it, and a capture 34-36); a capture outside any frame 50-52;
    two decodes of 4 and 6 ms and the step that ends the sequence, 1 ms."""
    ms = 1_000_000
    ticks = iter([t * ms for t in (
        0, 2, 3, 6, 8, 8, 9, 10,
        20, 22, 24, 30, 31, 33, 34, 36, 39, 40,
        50, 52,
        60, 64, 70, 76, 80, 81)])
    monkeypatch.setattr(tracer, "_clock", lambda: next(ticks))
    tracer.enable()
    with tracer.span("tracker.frame", 0):
        with tracer.span("tracker.wait"):
            pass
        with tracer.span("tracker.wait"):
            pass
        with tracer.span("tracker.post"):
            pass
    with tracer.span("tracker.frame", 1):
        with tracer.span("tracker.wait"):
            pass
        with tracer.span("kf.insert"):
            with tracer.span("kf_cycle.wait"):
                pass
            with tracer.span("graphs.capture"):
                pass
    with tracer.span("graphs.capture"):
        pass
    for fid in (0, 1, None):
        with tracer.span("input.decode") as sp:
            if fid is not None:
                sp.set_frame(fid)
    tracer.count("tracker.frames", 2)
    tracer.count("tracker.fine_map_rebuilds")
    tracer.disable()


@pytest.mark.parametrize("name,want", [
    ("input.decode_ms", 5.0),
    # frame 0: 10 - 1 - 2 = 7; frame 1: 20 - 2 - 9 = 9
    ("tracker.host_ms", 8.0),
    ("tracker.wait_ms", 2.5),
    ("kf_cycle.wait_ms", 2.0),
    ("graphs.capture_s", 0.004),
    ("tracker.fine_rebuild_pct", 50.0)])
def test_each_reader_on_a_hand_made_window(monkeypatch, name, want):
    _window(monkeypatch)
    assert load_reader(name).read(None) == pytest.approx(want)


def test_a_reader_with_nothing_to_read_returns_none(monkeypatch):
    tracer.enable()
    with tracer.span("finalize"):
        pass
    tracer.disable()
    for name in ("input.decode_ms", "tracker.host_ms", "tracker.wait_ms",
                 "kf_cycle.wait_ms", "tracker.fine_rebuild_pct"):
        assert load_reader(name).read(None) is None
    assert load_reader("graphs.capture_s").read(None) == 0.0


class Ev:
    def __init__(self, name, a, b):
        self._n, self._a, self._b = name, a, b

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return DeviceType.CUDA


class Fake(T.DeviceTrace):
    def __init__(self, events, host_open, host_close):
        super().__init__()
        self.prof = type("P", (), {})()
        self.prof.profiler = type("Q", (), {})()
        self.prof.profiler.kineto_results = type(
            "R", (), {"events": lambda self_: events})()
        self.host_open_ns, self.host_close_ns = host_open, host_close


def test_program_spans_split_the_idle_and_change_nothing_else():
    """The device is busy 100-300 and 700-800 of a window 0-1000; the
    probes say the host was in process_frame 50-950; the program's spans
    inside it: tracker.frame 50-900 with tracker.fine_map 320-500 and
    tracker.wait 600-750."""
    ev = [Ev("spin_kernel", 0, 10), Ev("k", 100, 300), Ev("k", 700, 800)]
    probes = [("session", 0, 1000), ("SlamSystem.process_frame", 50, 950)]
    program = [("tracker.frame", 50, 900), ("tracker.fine_map", 320, 500),
               ("tracker.wait", 600, 750)]
    alone = T.summarize(Fake(ev, 0, 1000), probes)
    both = T.summarize(Fake(ev, 0, 1000), probes + program)
    for k in ("busy_s", "window_s", "ops", "n_ops"):
        assert both[k] == alone[k]
    assert (sum(both["idle_by_span"].values())
            == pytest.approx(sum(alone["idle_by_span"].values())))
    idle = {k: v * 1e9 for k, v in both["idle_by_span"].items()}
    # gaps 0-100, 300-700, 800-1000
    assert idle == pytest.approx({
        "session": 50 + 50, "SlamSystem.process_frame": 50,
        "tracker.frame": 50 + 20 + 100 + 100, "tracker.fine_map": 180,
        "tracker.wait": 100})
