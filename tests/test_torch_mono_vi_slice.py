"""The monocular visual-inertial slice end to end: the port against the JAX
package.

Both packages run tests/test_windowed_vi.py's scenario (3000-point world,
seed 5, the excited orbit at 10 fps, IMU at 200 Hz with gyro bias
[0.01, -0.008, 0.012] and noise, LBA slots 24 / 4096 / 8, window 8,
two-stage) on the same frames through ``WindowedRunner``: monocular
two-view initialization, the gyro-bias and gravity / scale stages inside
the run, gyro-predicted windows, then
``finalize(gba_iterations=2, vi_alternations=3)``.  The JAX runner is
pinned to one window per fetch, the port's schedule.

Both packages draw the same RANSAC hypotheses (the port's threefry draws
in float64, as JAX's under the tests' x64), but their float32 arithmetic
differs in the last bits, so the runs are held by what they reach, not by
trajectories (tests/test_torch_lane_trace.py holds the trace).  Both: ``gyro_initialized`` and ``gravity_initialized``,
bg within 5e-3 of the truth, Sim3 alignment scale within 0.12 of 1 and
Sim3 ATE under 0.1 m (tests/test_windowed_vi.py's conditions).  Port
against JAX: tracked frames within 2, keyframes within 10% (at least 1),
alignment scales within 0.05 of each other, ATE within 3x of each other
(both are a few mm, a tenth of the gate).  ``finalize`` degrades neither:
ATE at most 3x its value before it and under 0.05 m, scale within 0.1 of 1,
bg within 2e-3 (tests/test_e2e_mono_vi.py's conditions).
"""

import numpy as np
import pytest

from test_torch_slice import jax_one_window_per_fetch

from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.utils import vi_problems as VP

N_FRAMES = 64


def _summary(system, runner):
    sol = system.imu_solver
    ate, scale, n = system.ate_against_gt(with_scale=True)
    return dict(tracked=len(system.tracker.trajectory),
                keyframes=int(system.map.n_keyframes),
                gyro=bool(sol.gyro_initialized),
                gravity=bool(sol.gravity_initialized),
                bg_err=float(np.abs(sol.bg - VP.BG_TRUE).max()),
                ate=float(ate), scale=float(scale), n=int(n),
                windows=int(runner.n_device_calls),
                transforms=int(getattr(system.map, "n_transforms", 0)))


def _finalized(system):
    system.finalize(gba_iterations=2, vi_alternations=3)
    ate, scale, _ = system.ate_against_gt(with_scale=True)
    sol = system.imu_solver
    return dict(ate=float(ate), scale=float(scale),
                bg_err=float(np.abs(sol.bg - VP.BG_TRUE).max()),
                keyframes=int(system.map.n_keyframes))


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads while the runs are made: the test workers
    share the machine's cores, and oversubscribed thread pools spin."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(few_threads):
    from snakeslam_tpu.frontend.synthetic_source import (
        apply_world_to_settings as j_apply)
    from snakeslam_tpu.map.slam_map import FrameData as JFrame
    from snakeslam_tpu.system.settings import InputType as JIT, \
        Settings as JSettings
    from snakeslam_tpu.system.slam import SlamSystem as JSystem
    from snakeslam_tpu.tracking.windowed import WindowedRunner as JRunner
    from snakeslam_tpu.utils.synthetic import SyntheticWorld as JWorld
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld

    kw = dict(VP.SMALL, n_frames=N_FRAMES)
    tsys, frames = VP.build_lane("cpu", **kw)
    trunner = WindowedRunner(tsys, window=VP.SMALL_WINDOW)
    with prng.x64(True):
        trunner.run(frames)
        port = _summary(tsys, trunner)
        port_final = _finalized(tsys)

    js = JSettings()
    js.input_type = JIT.Mono
    js.enable_imu = True
    js.feature_slots = 1024
    js.local_map_slots = 2048
    js.lba_cam_slots, js.lba_point_slots, js.lba_obs_slots = kw["lba_slots"]
    j_apply(JWorld(n_points=kw["n_points"], seed=kw["seed"]), js)
    jsys = JSystem(js)
    # the same frames, made anew (a run writes poses into its frames)
    jframes = VP.lane_frames(
        tsys.s, SyntheticWorld(n_points=kw["n_points"], seed=kw["seed"]),
        N_FRAMES, kw["fps"], frame_cls=JFrame)
    with jax_one_window_per_fetch():
        jrunner = JRunner(jsys, window=VP.SMALL_WINDOW, two_stage=True)
        jrunner.run(jframes)
    jax_ = _summary(jsys, jrunner)
    jax_final = _finalized(jsys)
    return dict(port=port, jax=jax_, port_final=port_final,
                jax_final=jax_final, runner=trunner)


@pytest.mark.parametrize("who", ["port", "jax"])
def test_visual_inertial_initialization(runs, who):
    r = runs[who]
    assert r["gyro"], "gyro bias never initialized"
    assert r["gravity"], "gravity / scale never initialized"
    assert r["bg_err"] < 5e-3
    assert r["transforms"] >= 1
    assert abs(r["scale"] - 1.0) < 0.12
    assert r["ate"] < 0.1


def test_counts_against_jax(runs):
    p, j = runs["port"], runs["jax"]
    assert abs(p["tracked"] - j["tracked"]) <= 2
    assert p["tracked"] >= N_FRAMES - 6
    assert abs(p["keyframes"] - j["keyframes"]) <= max(1, 0.1 * j["keyframes"])
    assert p["windows"] > 0


def test_scale_and_ate_against_jax(runs):
    p, j = runs["port"], runs["jax"]
    assert abs(p["scale"] - j["scale"]) < 0.05
    assert p["ate"] <= 3.0 * j["ate"] and j["ate"] <= 3.0 * p["ate"]


def test_runner_restarted_on_the_scale_transform(runs):
    # the gravity / scale stage rescales the whole map inside a keyframe
    # cycle's commit: the chain restarts, once per transform
    assert runs["runner"].n_chain_restarts == runs["port"]["transforms"]


@pytest.mark.parametrize("who", ["port", "jax"])
def test_finalize_does_not_degrade(runs, who):
    before, after = runs[who], runs[who + "_final"]
    assert after["ate"] <= max(3.0 * before["ate"], 0.01)
    assert after["ate"] < 0.05
    assert abs(after["scale"] - 1.0) < 0.1
    assert after["bg_err"] < 2e-3
    assert after["keyframes"] >= 3
