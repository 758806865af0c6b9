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


GEN = "_scratch_mono_imu"              # the throw-away cell's files
NUM = "_scratch_imu_kept"
IMU_PER_FRAME = 20

GEN_SOURCE = '''"""Monocular feature-level frames with IMU samples and no depth."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from traffic.frames import feature_frames
from traffic.sequence import Sequence, true_centres
from traffic.synthetic import SyntheticWorld, orbit_trajectory


@dataclass
class MonoImuFrame:
    frame_id: int
    timestamp: float
    uv: np.ndarray
    octave: np.ndarray
    angle: np.ndarray
    descriptors: np.ndarray
    right: np.ndarray
    depth: None
    gt_pose_cw: np.ndarray
    imu_omega: np.ndarray
    imu_acc: np.ndarray
    imu_dt: np.ndarray
    imu_t: np.ndarray


def sequences(cell, seeds, workdir):
    t = cell.traffic
    k = t["imu_per_frame"]
    dt = 1.0 / (t["fps"] * k)

    def frames(seed, n):
        world = SyntheticWorld(n_points=t["world_points"], seed=seed)
        traj = orbit_trajectory(n, radius=t["radius_m"], arc=t["arc_rad"],
                                fps=t["fps"])
        rng = np.random.default_rng(seed)
        return [MonoImuFrame(
            r.frame_id, r.timestamp, r.uv, r.octave, r.angle, r.descriptors,
            r.right, None, r.gt_pose_cw, rng.normal(0.0, 1e-3, (k, 3)),
            np.array([0.0, 0.0, 9.81]) + rng.normal(0.0, 1e-2, (k, 3)),
            np.full(k, dt), r.timestamp - k * dt + dt * np.arange(k))
            for r in feature_frames(world, traj, stereo=False,
                                    noise_px=t["noise_px"])]

    seqs = []
    for s in seeds[:-1]:
        raw = frames(s, t["frames"])
        seqs.append(Sequence(raw=raw, frames=len(raw),
                             truth=true_centres(raw)))
    warm = frames(seeds[-1], t["warmup"]["frames"])
    return seqs, Sequence(raw=warm, frames=len(warm))
'''

NUM_SOURCE = f'''"""Per finished session, the keyframes its hook counted after finalize
against the map the recorder kept: 0 where the hook ran on that map."""
import numpy as np

NAME = "{NUM}"
calls = {{"map": 0, "frame": 0}}


def keep_map(system):
    calls["map"] += 1
    return len(system.map.valid_keyframes())


def keep_frame(frame):
    calls["frame"] += 1
    return -1 if frame.imu_omega is None else len(frame.imu_omega)


def measure(rec, cell, runner, dtype, device, seed):
    return np.array([abs(m.extra[NAME] - len(m.kf_ids)) for m in rec.maps])
'''


def test_a_new_cell_is_new_files_alone():
    """A cell whose generator, configuration, traffic and judge number are
    new files, monocular with IMU samples and no depth, runs through
    ``load_cell``, ``Runner``, ``run_window`` and the run's judge on the
    CPU: its frames reach the program with their IMU samples, the judge
    computes exactly the numbers its limits list (``init_gap_mm``, which
    would read the init frame's depth, is not among them), and the number's
    hooks record what it reads; no file of the harness names these."""
    import inspect

    import numpy as np
    import torch

    import run as RUN
    from harness import (Runner, cleanup, frame_data, make_sequences,
                         run_window, workdir_for)
    from reference.judge import NUMBERS

    config = json.loads((HERE / "configs" / "euroc_stereo_vo.json")
                        .read_text())
    config["name"] = GEN
    config["ini"]["Input"]["input_type"] = 0
    traffic = dict(generator=GEN, world_points=3000, frames=10,
                   arc_rad=0.2, radius_m=7.0, fps=10.0, noise_px=0.3,
                   imu_per_frame=IMU_PER_FRAME, sequences=1, window=8,
                   warmup=dict(frames=4),
                   limits={"frame_excess_chi2": 1e9, NUM: 0.0})
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": GEN, "source": "x",
                         "file": f"slambench/configs/{GEN}.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": f"{GEN}.tiny", "config": GEN,
                           "traffic": "tiny", "chips": 1, "why": "x"})
    made_numbers = not NUMBERS.exists()
    files = {HERE / "traffic" / f"{GEN}.py": GEN_SOURCE,
             HERE / "configs" / f"{GEN}.json": json.dumps(config),
             HERE / "workloads" / f"{GEN}.tiny.json": json.dumps(traffic),
             NUMBERS / f"{NUM}.py": NUM_SOURCE}
    wd = workdir_for("new-files")
    try:
        NUMBERS.mkdir(exist_ok=True)
        for path, text in files.items():
            path.write_text(text)
        cell = load_cell(f"{GEN}.tiny", m)
        assert cell.config == config and cell.traffic == traffic
        torch.set_num_threads(2)
        r = Runner(cell, 2**31 + 7, "cpu", wd)
        assert r.numbers == ["frame_excess_chi2", NUM]
        assert [len(q.raw) for q in r.seqs] == [10] and r.warm.frames == 4

        from snakeslam_tpu_torch.map.slam_map import FrameData
        raw = r.seqs[0].raw[3]
        fd = frame_data(raw, FrameData)
        for k in ("imu_omega", "imu_acc", "imu_dt", "imu_t", "uv",
                  "descriptors"):
            assert np.array_equal(getattr(fd, k), getattr(raw, k)), k
        assert fd.depth is None and fd.gt_pose_cw is None

        hooks = r.number_modules[NUM]
        rec = run_window(r, 10.0)
        assert rec.maps, "no session finished: the map hook never ran"
        assert any(f.kind == "init" and f.depth is None for f in rec.frames)
        ok, checks = RUN.judge(cell, rec, r, 2**31 + 7, device="cpu")
        assert set(checks) == set(traffic["limits"])
        assert checks[NUM]["value"] == 0.0 and ok, checks
        assert hooks.calls["map"] == len(rec.maps)
        assert all(mr.extra[NUM] >= 3 for mr in rec.maps)
        assert hooks.calls["frame"] == len(rec.frames)
        assert all(f.extra == {NUM: IMU_PER_FRAME} for f in rec.frames)
    finally:
        for path in files:
            path.unlink(missing_ok=True)
        if made_numbers:
            NUMBERS.rmdir()
        cleanup(wd)
    for name in ("harness.py", "run.py", "calibrate.py",
                 "reference/judge.py"):
        text = (HERE / name).read_text()
        assert GEN not in text and NUM not in text, name
    src = inspect.getsource(make_sequences)
    assert "feature_frames" not in src and "tum_render" not in src
    for name in ("run.py", "calibrate.py"):
        assert '"generator"' not in (HERE / name).read_text(), name
