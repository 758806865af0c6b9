"""The stereo tracking slice end to end: the port against the JAX package.

Both packages run the dense-keyframe configuration of the bench warm-up
(1500-point world, seed 7, 48 frames, timestamp = frame_id / 10,
feature_slots 512, window 8) through ``WindowedRunner`` with the keyframe
back-end reduced to its synchronous half in both: no triangulation,
fusion, local BA or loop / simplification / deferred-mapper back-ends
(tests/test_torch_backend_slice.py runs the full back-end).

Tolerances: tracked and keyframe counts equal; map points within 2%;
per-frame camera centres within 1 mm; ATE within 10% of the JAX run.

The JAX package's runner also consumes, in one fetch, later windows whose
results have already landed, so its schedule depends on timing (a cold
compile stalls the host long enough for several windows to land).  The
port consumes one window per fetch; the JAX runs here are pinned to that
schedule (``jax_one_window_per_fetch``), which is what the JAX package
runs when the device is the slower side.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
N_FRAMES, WINDOW = 48, 8


@contextlib.contextmanager
def jax_one_window_per_fetch():
    """The JAX runner with its opportunistic multi-window consume off."""
    from snakeslam_tpu.tracking import windowed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(windowed._InFlight, "ready", lambda self: False)
        yield


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
    # the reduced back-end configuration, through its own branches
    lm.lba = None
    lm.map_searcher = None
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None
    frames = _frames(synthetic_frames, orbit_trajectory, world, s)
    with jax_one_window_per_fetch():
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
    lm = system.local_mapper
    lm.lba = None
    lm.map_searcher = None
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None
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
for f in frames:
    f.timestamp = f.frame_id / 10.0   # dense keyframes: the back-end runs
WindowedRunner(system, window=4).run(frames)
assert len(system.tracker.trajectory) == 10, len(system.tracker.trajectory)
assert system.lba.n_runs > 0, "the keyframe back-end did not run"

# the keyframe back-end's modules
import snakeslam_tpu_torch.map.kf_pool
import snakeslam_tpu_torch.mapping.fusion
import snakeslam_tpu_torch.ops.ba
import snakeslam_tpu_torch.ops.depth_grid
import snakeslam_tpu_torch.ops.triangulate_pairs
import snakeslam_tpu_torch.ops.triangulation
import snakeslam_tpu_torch.ops.twoview
import snakeslam_tpu_torch.optim.deferred_mapper
import snakeslam_tpu_torch.optim.lba
import snakeslam_tpu_torch.optim.packing
import snakeslam_tpu_torch.optim.simplification
import snakeslam_tpu_torch.system.queues
from snakeslam_tpu_torch.tracking.staging import kf_features_cached
# the system glue's modules
import snakeslam_tpu_torch.loop.keyframe_database
import snakeslam_tpu_torch.loop.loop_closing
import snakeslam_tpu_torch.loop.relocalization
import snakeslam_tpu_torch.ops.bow
import snakeslam_tpu_torch.ops.pgo
import snakeslam_tpu_torch.ops.sim3_solver
import snakeslam_tpu_torch.optim.gba
system.finalize()
kf_features_cached(system.map, int(system.map.valid_keyframes()[0]), 256,
                   "cpu")

# the monocular visual-inertial modules, and a mono initialization
import snakeslam_tpu_torch.imu.state_solver
import snakeslam_tpu_torch.ops.imu
import snakeslam_tpu_torch.tracking.mono_init
import snakeslam_tpu_torch.utils.imu_synthetic
from snakeslam_tpu_torch.utils import vi_problems

msys, mframes = vi_problems.build_lane("cpu", n_frames=6, fps=10.0,
                                       n_points=1500, seed=5,
                                       lba_slots=(24, 4096, 8))
for f in mframes:
    msys.process_frame(f)
assert msys.map.n_keyframes >= 2, "mono initialization did not land"
assert msys.imu_solver.edges or msys.imu_solver.pending_samples

# the pixels-in modules: render, extract, match, cache
import numpy as np
from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
from snakeslam_tpu_torch.frontend.pixels import PixelFrameSequence
from snakeslam_tpu_torch.frontend.preprocess import Preprocess
from snakeslam_tpu_torch.utils import native
from snakeslam_tpu_torch.utils.render_world import render_sequence

pw = SyntheticWorld(n_points=300, seed=5, image_size=(160, 120), fx=130.0,
                    fy=130.0, cx=80.0, cy=60.0, baseline=0.12, extent=8.0)
ps = Settings()
ps.input_type = InputType.Stereo
ps.enable_imu = False
ps.width, ps.height = 160, 120
ps.fx, ps.fy, ps.cx, ps.cy = 130.0, 130.0, 80.0, 60.0
ps.bf = 130.0 * 0.12
ps.fd_features = 200
ps.fd_levels = 2
views = list(render_sequence(pw, orbit_trajectory(4, radius=6.5, arc=0.05)))
L = np.stack([l.astype(np.uint8) for _, _, l, _ in views])
R = np.stack([r.astype(np.uint8) for _, _, _, r in views])
seq = PixelFrameSequence(ps, L, R, [v[0] for v in views], chunk=2,
                         device="cpu")
assert len(seq[0:4]) == 4 and min(f.n for f in seq[0:4]) > 50
det = FeatureDetector(ps, device="cpu")
f = det.detect(L[0], 0, 0.0)
assert Preprocess(ps, device="cpu").stereo_match(
    f, det.detect(R[0], 1, 0.0)) > 0
native.available()

# the dataset CLI and its modules: a 3-frame rendered TUM sequence through
# the CLI on the CPU, the depth filter, TSDF, checkpoints, chaos, rectify
import contextlib, io, shutil, tempfile
from pathlib import Path
import torch
import snakeslam_tpu_torch.__main__ as cli
import snakeslam_tpu_torch.frontend.stereo_rectify
import snakeslam_tpu_torch.map.chaos
import snakeslam_tpu_torch.system.pipeline
import snakeslam_tpu_torch.viewer.plot
from snakeslam_tpu_torch.frontend.depth_processor import DepthProcessor
from snakeslam_tpu_torch.map.serialization import load_map, save_map
from snakeslam_tpu_torch.ops import tsdf
from snakeslam_tpu_torch.utils import tum_fixture

tmp = Path(tempfile.mkdtemp())
tum_fixture.write_tum_fixture(tmp / "tum", tum_fixture.lane_world(scale=0.25),
                              tum_fixture.lane_trajectory(3))
shutil.copy("configs/tum.ini", tmp / "tum.ini")
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main([str(tmp / "tum.ini"), "--dataset", str(tmp / "tum"),
                     "--outDir", str(tmp / "out"), "--device", "cpu",
                     "--profile", "--overlayEvery", "2"]) == 0
assert (tmp / "out" / "trajectory_frames_ba.tum").exists()
assert (tmp / "out" / "trace" / "trace.json").exists()
assert sorted(p.name for p in (tmp / "out" / "frames").iterdir()) == [
    "frame_000000.png", "frame_000002.png"]
d = DepthProcessor(fx=500.0, bf=40.0, device="cpu").process(
    np.full((24, 32), 2.0, np.float32))
vol = tsdf.integrate(tsdf.create_volume(8, device="cpu"),
                     torch.full((24, 32), 1.0), torch.eye(4), 30.0, 30.0,
                     16.0, 12.0, 0.1)
save_map(system.map, tmp / "map.npz")
assert load_map(tmp / "map.npz").n_keyframes == system.map.n_keyframes

# the multi-device path and the entry points
from snakeslam_tpu_torch.entry import dryrun_multichip, entry
dryrun_multichip(2, "cpu")
fn, args = entry("cpu")
fn(*args)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "snakeslam_tpu.")))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


@pytest.mark.parametrize("field,value", [("input_type", "mono"),
                                         ("enable_imu", True),
                                         ("async_mode", True),
                                         ("n_devices", 2)])
def test_unported_settings_raise(field, value):
    """Monocular input, ``enable_imu``, ``async_mode`` and ``n_devices``
    construct (with the mono initializer, the IMU state solver, the queues'
    worker threads and the global BA's device mesh wired in)."""
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem

    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    setattr(s, field, InputType.Mono if value == "mono" else value)
    system = SlamSystem(s, "cpu")
    if field == "n_devices":
        mesh = system.loop_closing.gba._mesh
        assert mesh.size == 2 and not mesh.distinct
        assert system.loop_closing.gba._sharded_fns == {}
    elif field == "async_mode":
        assert system._simp_queue.parallel and system._deferred_queue.parallel
        assert system._async_lba is None
        system.finalize()   # joins the workers
        assert not system._simp_queue._thread.is_alive()
    elif field == "input_type":
        assert system.tracker.mono_initializer is not None
        assert system.loop_closing.use_scale
        assert float(system.tracker.coarse_radius) == 15.0
        assert float(system.tracker.fine_th) == 5.0
    else:
        sol = system.imu_solver
        assert sol is not None and sol.gba is not None
        assert system.lba.imu_solver is sol
        assert system.tracker.imu_solver is sol
        assert system.local_mapper.imu_solver is sol
        assert system.simplification.imu_solver is sol


def test_unported_entry_points_raise():
    """Every entry point of a monocular, IMU, async or multi-device system
    constructs and runs; the only refusal left is a mesh whose shard count
    does not divide the full BA's point slots (``ValueError``)."""
    from snakeslam_tpu_torch.optim.gba import GlobalBA
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem

    s = Settings()
    s.input_type = InputType.Mono
    s.enable_imu = True
    system = SlamSystem(s, "cpu")          # monocular + IMU constructs
    # run and finalize are ported (the system glue): an empty run is a no-op
    assert system.run([]) >= 0.0
    system.finalize()
    assert system.map.n_keyframes == 0
    # the global BA takes the IMU solver's relative-pose factors
    assert GlobalBA(s, system.map, "cpu",
                    imu_solver=system.imu_solver).imu_solver is not None
    # async mode and the async local BA construct; so does multi-device,
    # with a mesh of the shards asked for
    s = Settings()
    s.async_mode = s.async_lba = True
    system = SlamSystem(s, "cpu")
    assert system.local_mapper.lba is system._async_lba
    assert system.run([]) >= 0.0
    multi = Settings()
    multi.n_devices = 2
    msys = SlamSystem(multi, "cpu")        # monocular + IMU, 2 shards
    assert msys.loop_closing.gba._mesh.size == 2
    assert msys.imu_solver.gba._mesh.size == 2
    assert GlobalBA(multi, system.map, "cpu")._mesh.size == 2
    # 3 shards do not split the full BA's 256 point slots evenly
    from snakeslam_tpu_torch.parallel.multichip import dryrun_map

    s3, smap3, _ = dryrun_map(3)
    with pytest.raises(ValueError, match="equal shards"):
        GlobalBA(s3, smap3, "cpu").full_ba(iterations=1)
