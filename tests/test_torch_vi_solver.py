"""The IMU state solver's stages: the port against the JAX package.

A 14-keyframe chain on the excited orbit (``utils/vi_problems.build_chain``:
visual frame under-scaled by 2.7 and tilted, 200 Hz IMU with gyro bias and
noise) is built once with the port's classes and carried into the JAX
package (the map by ``clone_map``, the solver's state by
``utils/convert.py``), so both start every stage from the same state.

Tolerances (float64 on both sides): ``_stage_gyro``: bg within 1e-9, the
same stage after it; ``_stage_gravity_scale``: init scale, gravity, the
transformed keyframe poses and the velocities within 1e-7, the same stage
and weights; ``_solve_chain`` without and with scale: bg, ba, velocities,
poses within 1e-7; ``rpc_for_window`` identical (1e-12); the edge merge on
a keyframe cull as tests/test_imu.py; the tracker's transform listener
against the JAX tracker's (1e-12); a map reset keeps the solver's
erase hook registered exactly once.
"""

import numpy as np
import pytest

from snakeslam_tpu.imu import state_solver as JS
from snakeslam_tpu.map.slam_map import SlamMap as JMap
from snakeslam_tpu.system.settings import InputType as JIT, \
    Settings as JSettings
from snakeslam_tpu_torch.imu import state_solver as TS
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.ops import imu as IMU
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.utils import vi_problems as VP
from snakeslam_tpu_torch.utils.convert import (imu_solver_state,
                                                load_imu_solver_state)
from snakeslam_tpu_torch.utils.loop_problems import clone_map


def _jax_settings():
    s = JSettings()
    s.input_type = JIT.Mono
    s.enable_imu = True
    return s


@pytest.fixture(scope="module")
def chain0():
    return VP.build_chain(TS.ImuStateSolver, device="cpu")


def _pair(chain0):
    """Fresh (port solver, JAX solver) on copies of the fixture's state."""
    s, smap, sol, kfs = chain0
    state = imu_solver_state(sol)
    tm = clone_map(smap)
    tsol = TS.ImuStateSolver(s, tm, "cpu")
    load_imu_solver_state(tsol, state, TS.ImuEdge)
    jm = clone_map(smap, cls=JMap)
    jsol = JS.ImuStateSolver(_jax_settings(), jm)
    load_imu_solver_state(jsol, state, JS.ImuEdge)
    return tsol, jsol, kfs


def _assert_same(tsol, jsol, kfs, atol):
    np.testing.assert_allclose(tsol.bg, jsol.bg, atol=atol)
    np.testing.assert_allclose(tsol.ba, jsol.ba, atol=atol)
    np.testing.assert_allclose(tsol.gravity, jsol.gravity, atol=atol)
    assert tsol.stage.name == jsol.stage.name
    assert tsol.gyro_initialized == jsol.gyro_initialized
    assert tsol.gravity_initialized == jsol.gravity_initialized
    assert tsol.current_gyro_weight == jsol.current_gyro_weight
    assert tsol.current_acc_weight == jsol.current_acc_weight
    np.testing.assert_allclose(tsol.map.kf_pose[kfs], jsol.map.kf_pose[kfs],
                               atol=atol)
    np.testing.assert_allclose(tsol.map.kf_velocity[kfs],
                               jsol.map.kf_velocity[kfs], atol=atol)


def test_state_carried_across(chain0):
    tsol, jsol, kfs = _pair(chain0)
    assert len(tsol.edges) == len(jsol.edges) == len(kfs) - 1
    for kf in tsol.edges:
        for a, b in zip(tsol.edges[kf].preint, jsol.edges[kf].preint):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-12)
    assert len(tsol._chain_keyframes()) == len(jsol._chain_keyframes()) == 13


def _after_gyro(chain0):
    tsol, jsol, kfs = _pair(chain0)
    tsol._stage_gyro()
    jsol._stage_gyro()
    return tsol, jsol, kfs


def test_stage_gyro(chain0):
    tsol, jsol, kfs = _after_gyro(chain0)
    _assert_same(tsol, jsol, kfs, 1e-9)
    assert tsol.gyro_initialized and tsol.stage == TS.VIStage.GRAVITY_SCALE
    assert np.abs(tsol.bg - VP.BG_TRUE).max() < 2e-3


def _after_gravity(chain0):
    tsol, jsol, kfs = _after_gyro(chain0)
    n0 = tsol.map.n_transforms if hasattr(tsol.map, "n_transforms") else 0
    tsol._stage_gravity_scale()
    jsol._stage_gravity_scale()
    assert tsol.map.n_transforms == n0 + 1
    return tsol, jsol, kfs


def test_stage_gravity_scale(chain0):
    tsol, jsol, kfs = _after_gravity(chain0)
    assert tsol.gravity_initialized and tsol.stage == TS.VIStage.OPTIMIZING
    assert abs(tsol.init_scale - jsol.init_scale) < 1e-7
    assert tsol.init_done_time == jsol.init_done_time
    _assert_same(tsol, jsol, kfs, 1e-7)
    # the stage found the fixture's scale and levelled its tilt
    assert abs(tsol.init_scale - VP.CHAIN_SCALE) / VP.CHAIN_SCALE < 0.06
    R_wb, p_wb = VP.orbit_pose_wb(0.5 * 6)
    c = -tsol.map.kf_pose[kfs[6]][:3, :3].T @ tsol.map.kf_pose[kfs[6]][:3, 3]
    c0 = -tsol.map.kf_pose[kfs[0]][:3, :3].T @ tsol.map.kf_pose[kfs[0]][:3, 3]
    _, p0 = VP.orbit_pose_wb(0.0)
    assert abs((c - c0)[2] - (p_wb - p0)[2]) < 0.1      # height is metric


@pytest.mark.parametrize("solve_scale", [False, True])
def test_solve_chain(chain0, solve_scale):
    tsol, jsol, kfs = _after_gravity(chain0)
    if solve_scale:
        # off metric by 4%, so the scale pass has something to apply
        for sol in (tsol, jsol):
            sol.map.transform(1.04, np.eye(3), np.zeros(3))
            sol.recompute_weights()
    bg_before = tsol.bg.copy()
    tsol._solve_chain(solve_scale=solve_scale)
    jsol._solve_chain(solve_scale=solve_scale)
    assert np.abs(tsol.bg - bg_before).max() > 0       # it was accepted
    _assert_same(tsol, jsol, kfs, 1e-7)
    if solve_scale:
        assert tsol.map.n_transforms == jsol.map.n_transforms == 3


def test_rpc_for_window_identical(chain0):
    tsol, jsol, kfs = _pair(chain0)
    assert tsol.rpc_for_window(kfs) is None and \
        jsol.rpc_for_window(kfs) is None          # before the gyro stage
    tsol._stage_gyro()
    jsol._stage_gyro()
    window = kfs[3:11]
    rt, rj = tsol.rpc_for_window(window), jsol.rpc_for_window(window)
    assert len(rt) == len(rj) == len(window) - 1
    for a, b in zip(rt, rj):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(a[2], b[2], atol=1e-12)
        assert a[3] == b[3] == 0.0
        assert abs(a[4] - b[4]) < 1e-9


def test_lba_pack_carries_the_gyro_factors(chain0):
    from snakeslam_tpu_torch.optim.lba import pack_rpc

    tsol, _, kfs = _pair(chain0)
    slot_of_kf = {k: i for i, k in enumerate(kfs)}
    out = pack_rpc(tsol, kfs, slot_of_kf, 24, np.float32)
    assert not out[4].any()                       # before the gyro stage
    tsol._stage_gyro()
    rpc_i, rpc_j, rpc_T, rpc_w, rpc_valid = pack_rpc(
        tsol, kfs, slot_of_kf, 24, np.float32)
    assert rpc_valid.sum() == len(kfs) - 1 and not rpc_valid[13:].any()
    r = 4
    e = tsol.edges[kfs[rpc_j[r]]]
    assert kfs[rpc_i[r]] == e.prev_kf
    np.testing.assert_allclose(rpc_T[r][:3, :3], e.preint.dR.T, atol=1e-6)
    assert (rpc_w[r, :3] == 0).all() and (rpc_w[r, 3:] > 0).all()


def test_imu_sequence_merge_on_keyframe_cull():
    s = Settings()
    s.enable_imu = True
    smap = SlamMap(max_keyframes=16, max_points=64, max_features=8)
    sol = TS.ImuStateSolver(s, smap, "cpu")
    rate, dt_kf = 100.0, 0.5
    kfs = []
    rng = np.random.default_rng(0)
    for i in range(4):
        n = 4
        fd = FrameData(
            frame_id=i * 10, timestamp=i * dt_kf,
            uv=np.zeros((n, 2)), octave=np.zeros(n, np.int32),
            angle=np.zeros(n), descriptors=np.zeros((n, 32), np.uint8),
            right=np.full(n, -1.0), depth=np.full(n, -1.0))
        fd.pose_cw = np.eye(4)
        k = smap.allocate_keyframe(fd)
        if kfs:
            smap.kf_prev[k] = kfs[-1]
            smap.kf_next[kfs[-1]] = k
            ns = int(dt_kf * rate)
            fd.imu_omega = rng.normal(0, 0.01, (ns, 3))
            fd.imu_acc = rng.normal(0, 0.01, (ns, 3)) + [0, 0, 9.81]
            fd.imu_dt = np.full(ns, 1.0 / rate)
            fd.imu_t = (i - 1) * dt_kf + np.arange(ns) / rate
            sol.add_frame_samples(fd)
            sol.process_new_keyframe(k, kfs[-1])
        kfs.append(k)
    assert len(sol._chain_keyframes()) == 3
    smap.erase_keyframe(kfs[1])
    chain = sol._chain_keyframes()
    assert len(chain) == 2
    (i0, j0, e0), (i1, j1, e1) = chain
    assert (i0, j0) == (kfs[0], kfs[2]) and (i1, j1) == (kfs[2], kfs[3])
    assert abs(float(e0.preint.dt) - 2 * dt_kf) < 0.02
    assert len(e0.omega) == 2 * int(dt_kf * rate)
    assert sol._connected_suffix(chain) == chain
    # a map reset as the tracker does it (the map first: its clear drops
    # the erase hooks; the solver's clear re-runs its constructor, which
    # registers the hook again, once)
    smap.clear()
    sol.clear()
    sol.clear()
    hooks = [cb for cb in smap.on_erase_keyframe
             if getattr(cb, "__self__", None) is sol]
    assert len(hooks) == 1 and not sol.edges


def test_tracker_transform_listener_matches_jax(chain0):
    from snakeslam_tpu.map.slam_map import FrameData as JFrame
    from snakeslam_tpu.tracking.tracker import Tracker as JTracker
    from snakeslam_tpu_torch.tracking.tracker import Tracker

    s, smap, _, kfs = chain0
    tm, jm = clone_map(smap), clone_map(smap, cls=JMap)
    tt = Tracker(s, tm, "cpu")
    jt = JTracker(_jax_settings(), jm)
    rng = np.random.default_rng(1)
    for tr, cls in ((tt, FrameData), (jt, JFrame)):
        for i in range(5):
            f = VP.frame_as(FrameData(
                frame_id=i, timestamp=float(i), uv=np.zeros((2, 2)),
                octave=np.zeros(2, np.int32), angle=np.zeros(2),
                descriptors=np.zeros((2, 32), np.uint8),
                right=np.full(2, -1.0), depth=np.full(2, -1.0),
                gt_pose_cw=np.eye(4)), cls)
            f.pose_cw = smap.kf_pose[kfs[i]].copy()
            f.rel_to_ref = smap.kf_pose[kfs[i + 1]] @ np.linalg.inv(
                smap.kf_pose[kfs[i]])
            if i < 4:
                tr.trajectory.append(f)
        tr.last_frame = f                       # not in the trajectory
        tr.velocity = smap.kf_pose[kfs[5]] @ np.linalg.inv(
            smap.kf_pose[kfs[4]])
    R = IMU.so3_exp_np(rng.normal(scale=0.3, size=3))
    t = rng.normal(size=3)
    state0 = tm.state
    tm.transform(1.7, R, t)
    jm.transform(1.7, R, t)
    assert tm.state > state0 and tm.n_transforms == 1
    np.testing.assert_allclose(tm.kf_pose[kfs], jm.kf_pose[kfs], atol=1e-12)
    for a, b in zip(tt.trajectory + [tt.last_frame],
                    jt.trajectory + [jt.last_frame]):
        np.testing.assert_allclose(a.pose_cw, b.pose_cw, atol=1e-12)
        np.testing.assert_allclose(a.rel_to_ref, b.rel_to_ref, atol=1e-12)
    np.testing.assert_allclose(tt.velocity, jt.velocity, atol=1e-12)
    # the rebased frame poses still sit on the rebased keyframes
    np.testing.assert_allclose(tt.trajectory[2].pose_cw, tm.kf_pose[kfs[2]],
                               atol=1e-9)


def test_solver_needs_an_explicit_device():
    """Like every constructor of the port, the IMU state solver takes its
    device from the caller: without one it refuses to construct."""
    s = Settings()
    s.enable_imu = True
    smap = SlamMap(max_keyframes=4, max_points=8, max_features=4)
    with pytest.raises(TypeError, match="device"):
        TS.ImuStateSolver(s, smap)
    assert TS.ImuStateSolver(s, smap, "cpu").device.type == "cpu"
