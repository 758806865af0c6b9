"""The dataset input's ready share: its manifest entry, and its reader on
a hand-made window of the program's counters."""

import pytest

import program_trace as P
from harness import load_cell, load_manifest, load_reader
from probes import Probe, SpanLog
from snakeslam_tpu_torch.system import stats as tracer

CELL = "tum_rgbd_fr1.orbit300"


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def test_the_entry_is_in_the_manifest_and_the_cell():
    (m,) = [m for m in load_manifest()["per_layer"]
            if m["name"] == "input.ready_pct"]
    assert m == {"name": "input.ready_pct", "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "dataset input",
                 "moves": "fps", "workloads": [CELL]}
    assert "input.ready_pct" in {x["name"] for x in load_cell(CELL).per_layer}
    assert load_reader("input.ready_pct").PROBES == [P.SWITCH]


def test_the_reader_on_a_hand_made_window():
    probe = Probe(P.SWITCH, SpanLog())
    probe.install()
    try:
        tracer.count("input.frames", 8)
        for ready in (0, 1, 1, 1, 0, 1, 1, 1):
            tracer.count("input.frames_ready", ready)
    finally:
        probe.remove()
    assert load_reader("input.ready_pct").read(None) == pytest.approx(75.0)


def test_without_the_counters_it_reads_nothing(monkeypatch):
    reader = load_reader("input.ready_pct")
    tracer.enable()
    tracer.count("tracker.frames", 3)
    tracer.disable()
    assert reader.read(None) is None
    monkeypatch.setattr(P, "tracer", lambda: None)
    assert reader.read(None) is None
