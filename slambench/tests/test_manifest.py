"""BENCHMARK.json parses, keeps to the contract's shape, and every cell,
configuration and per-layer metric is found by name from its own file."""

import json
import re
from pathlib import Path

import pytest

from harness import HERE, REPO, load_cell, load_manifest, load_reader
from probes import resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = load_manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "slambench/run.py"]
    assert M["paths"] == ["slambench"]
    assert 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    n = 24
    assert ((2 + 14 * n) * (M["run_seconds"] + 60) + n * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in M[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in M["end_to_end"] + M["per_layer"]:
        base = ({"name", "unit", "better", "bound", "source"}
                if e in M["end_to_end"] else
                {"name", "unit", "better", "source", "layer", "moves"})
        assert set(e) - {"workloads"} == base, e
        assert NAME.match(e["name"]) and e["name"] not in names
        names.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and c["file"].startswith("slambench/")
        body = json.loads(path.read_text())
        assert body["name"] == c["name"]
        assert set(c["reduced"]) == set(body["reduced"])
        assert any(w["config"] == c["name"] for w in M["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_found_by_name(cell):
    c = load_cell(cell)
    assert c.entry["chips"] == 1
    assert (HERE / "workloads" / f"{cell}.json").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    # every number of the judge has its limit
    assert set(c.traffic["limits"]) >= {
        "frame_excess_chi2", "frame_excess_chi2_mean", "init_gap_mm",
        "kf_gap_mm", "point_excess_chi2"}


@pytest.mark.parametrize("metric", sorted(
    {m["name"] for m in M["per_layer"]}
    | {p.stem for p in (HERE / "metrics").glob("*.py")}))
def test_metric_reader_found_by_name(metric):
    """Every metric of the manifest has its reader, and every reader (the
    windowed path's too, which no cell reports yet) loads and finds the
    methods it probes."""
    mod = load_reader(metric)
    assert callable(mod.read)
    for spec in mod.PROBES:
        owner, name = resolve(spec)
        assert callable(getattr(owner, name))


def test_layers_are_named_alike():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    for layer in by_layer:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


def test_a_new_cell_is_data_alone(tmp_path):
    """A cell added by a manifest line and a traffic file is found with no
    edit to the harness."""
    m = json.loads(json.dumps(M))
    m["workloads"].append({"name": "tum_rgbd_fr1.extra",
                           "config": "tum_rgbd_fr1", "traffic": "extra",
                           "chips": 1, "why": "x"})
    src = HERE / "workloads" / "tum_rgbd_fr1.orbit300.json"
    dst = HERE / "workloads" / "tum_rgbd_fr1.extra.json"
    dst.write_text(src.read_text())
    try:
        c = load_cell("tum_rgbd_fr1.extra", m)
        assert c.traffic == json.loads(src.read_text())
    finally:
        dst.unlink()
