"""The stereo tracking slice end to end: the port against the JAX package.

Both packages run the dense-keyframe configuration of the bench warm-up
(1500-point world, seed 7, 48 frames, timestamp = frame_id / 10,
feature_slots 512, window 8) through ``WindowedRunner`` with the JAX
package in the port's back-end configuration: no triangulation, fusion,
local BA or loop / simplification / deferred-mapper back-ends.

Tolerances: tracked and keyframe counts equal; map points within 2%;
per-frame camera centres within 1 mm; ATE within 10% of the JAX run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
N_FRAMES, WINDOW = 48, 8


def _settings(Settings, InputType, world, apply_world_to_settings):
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 512
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    return s


def _frames(synthetic_frames, orbit_trajectory, world, s):
    frames = list(synthetic_frames(
        world, orbit_trajectory(N_FRAMES, radius=7.0,
                                arc=1.2 * N_FRAMES / 400.0, fps=200.0),
        s, noise_px=0.3))
    for f in frames:
        f.timestamp = f.frame_id / 10.0   # dense keyframes
    return frames


def _run_jax():
    from snakeslam_tpu.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu.system.settings import InputType, Settings
    from snakeslam_tpu.system.slam import SlamSystem
    from snakeslam_tpu.tracking.windowed import WindowedRunner
    from snakeslam_tpu.utils.synthetic import SyntheticWorld, orbit_trajectory

    world = SyntheticWorld(n_points=1500, seed=7)
    s = _settings(Settings, InputType, world, apply_world_to_settings)
    system = SlamSystem(s)
    lm = system.local_mapper
    # the back-end configuration the port runs: its own branches
    lm.lba = None
    lm.map_searcher = None
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None
    frames = _frames(synthetic_frames, orbit_trajectory, world, s)
    WindowedRunner(system, window=WINDOW).run(frames)
    return system


def _run_port():
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    world = SyntheticWorld(n_points=1500, seed=7)
    s = _settings(Settings, InputType, world, apply_world_to_settings)
    system = SlamSystem(s, "cpu")
    frames = _frames(synthetic_frames, orbit_trajectory, world, s)
    runner = WindowedRunner(system, window=WINDOW)
    runner.run(frames)
    return system, runner


@pytest.fixture(scope="module")
def runs():
    jax_sys = _run_jax()
    port_sys, runner = _run_port()
    return jax_sys, port_sys, runner


def _centres(system):
    out = {}
    for f in system.tracker.trajectory:
        pose = system.frame_pose_global(f)
        out[f.frame_id] = np.linalg.inv(pose)[:3, 3]
    return out


def test_tracked_and_keyframe_counts(runs):
    jax_sys, port_sys, runner = runs
    assert len(port_sys.tracker.trajectory) == N_FRAMES
    assert len(jax_sys.tracker.trajectory) == N_FRAMES
    assert port_sys.map.n_keyframes == jax_sys.map.n_keyframes == 10
    assert runner.n_device_calls < N_FRAMES


def test_point_count(runs):
    jax_sys, port_sys, _ = runs
    nj, nt = jax_sys.map.n_points, port_sys.map.n_points
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)


def test_camera_centres(runs):
    jax_sys, port_sys, _ = runs
    cj, ct = _centres(jax_sys), _centres(port_sys)
    assert cj.keys() == ct.keys()
    diff = max(np.linalg.norm(cj[k] - ct[k]) for k in cj)
    assert diff < 1e-3, f"max camera-centre difference {diff} m"


def test_ate(runs):
    jax_sys, port_sys, _ = runs
    ate_j, _, nj = jax_sys.ate_against_gt(with_scale=False)
    ate_t, _, nt = port_sys.ate_against_gt(with_scale=False)
    assert nj == nt == N_FRAMES
    assert abs(ate_t - ate_j) <= 0.1 * ate_j, (ate_t, ate_j)
    assert ate_t < 3e-3


def test_trajectory_export(runs, tmp_path):
    _, port_sys, _ = runs
    ts, pos, quat = port_sys.frame_trajectory()
    assert pos.shape == (N_FRAMES, 3) and quat.shape == (N_FRAMES, 4)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-5)
    port_sys.write_trajectories(tmp_path)
    assert (tmp_path / "trajectory_frames_ba.tum").exists()
    assert (tmp_path / "trajectory_keyframes_ba.tum").exists()


_NO_JAX_SCRIPT = """
import sys
import snakeslam_tpu_torch
from snakeslam_tpu_torch.frontend.synthetic_source import (
    apply_world_to_settings, synthetic_frames)
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.system.slam import SlamSystem
from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld, orbit_trajectory

world = SyntheticWorld(n_points=800, seed=3)
s = Settings()
s.input_type = InputType.Stereo
s.enable_imu = False
s.feature_slots = 256
s.local_map_slots = 1024
apply_world_to_settings(world, s)
system = SlamSystem(s, "cpu")
frames = list(synthetic_frames(world, orbit_trajectory(10, radius=7.0,
                                                       arc=0.03), s))
WindowedRunner(system, window=4).run(frames)
assert len(system.tracker.trajectory) == 10, len(system.tracker.trajectory)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "snakeslam_tpu.")))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


@pytest.mark.parametrize("field,value", [("input_type", "mono"),
                                         ("enable_imu", True),
                                         ("async_mode", True),
                                         ("n_devices", 2)])
def test_unported_settings_raise(field, value):
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem

    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    setattr(s, field, InputType.Mono if value == "mono" else value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SlamSystem(s, "cpu")


def test_unported_entry_points_raise():
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem

    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    system = SlamSystem(s, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        system.run([])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        system.finalize()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        system.map.kf_feature_pool(512)
