"""``window_track`` with the gyro prediction and single-stage, against the
JAX function; ``gyro_delta_rotation``; the runner's rebase restart.

The JAX package initializes a stereo map on the excited orbit, attaches the
gyro-predicted rotation of every frame and packs the window; the same
arrays go through the port's ``window_track`` (W = 4, 512 feature slots,
P = 1024) with ``use_imu=True`` (two-stage) and with ``two_stage=False``.
The carry's velocity is the identity, so with ``use_imu`` the predicted
rotation is the gyro's alone.

Tolerances, as tests/test_torch_window_step.py: poses atol 1e-4, inlier
counts within max(2, 1%), keyframe decisions identical, assignments
identical on >= 99%.  ``gyro_delta_rotation`` within 1e-12 of the JAX copy.
The packed row's cache is dropped when ``imu_dR_cam`` changes.

Rebase restart: a whole-map transform lands in a keyframe cycle's commit
while later windows are in flight; no window dispatched before the
transform may be consumed after it, the chain restarts once, and every
frame is still tracked with the ATE of the undisturbed run (within 10%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snakeslam_tpu.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu.models import window_step as jws
from snakeslam_tpu.system.settings import InputType, Settings
from snakeslam_tpu.system.slam import SlamSystem
from snakeslam_tpu.tracking import windowed as jwin
from snakeslam_tpu.utils.imu_synthetic import orbit_pose_wb, synth_imu
from snakeslam_tpu.utils.synthetic import SyntheticWorld
from snakeslam_tpu_torch.models import window_step as tws
from snakeslam_tpu_torch.tracking import windowed as twin
from snakeslam_tpu_torch.utils import vi_problems as VP
from snakeslam_tpu_torch.utils.convert import (
    local_map_from_numpy,
    pinhole_from_numpy,
    window_carry_from_numpy,
)

W, N_SLOTS, P_SLOTS = 4, 512, 1024
FPS = 10.0


@pytest.fixture(scope="module")
def jax_inputs():
    world = SyntheticWorld(n_points=1500, seed=5)
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = True
    s.feature_slots = N_SLOTS
    s.local_map_slots = P_SLOTS
    s.pin_local_map_bucket = True
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    system = SlamSystem(s)
    imu = synth_imu(orbit_pose_wb, 0.0, (W + 1) / FPS, rate=200.0,
                    bg=VP.BG_TRUE, gyro_noise=1e-4, acc_noise=1e-3)
    traj = ((i / FPS, VP.orbit_pose_cw(i / FPS)) for i in range(W + 1))
    frames = list(synthetic_frames(world, traj, s, imu=imu))
    system.process_frame(frames[0])      # stereo initialization
    sol = system.imu_solver
    sol.gyro_initialized = True
    sol.bg = VP.BG_TRUE.copy()
    runner = jwin.WindowedRunner(system, window=W)
    assert runner._use_imu()
    runner._attach_imu_prediction(frames[1:])
    lm, _, _ = runner._local_map()
    buf = jws.pack_frames_np(frames[1:], N_SLOTS)
    t = system.tracker
    carry = (np.asarray(t.last_frame.pose_cw, np.float32),
             np.eye(4, dtype=np.float32),
             runner._initial_dec_state(), np.zeros((), bool))
    return system, frames, lm, buf, carry


@pytest.mark.parametrize("two_stage,use_imu", [(True, True), (False, False)])
def test_window_track_parity(jax_inputs, two_stage, use_imu):
    system, frames, lm, buf, carry = jax_inputs
    t, s = system.tracker, system.s
    j_out = jws.window_track(
        lm, jnp.asarray(buf), *(jnp.asarray(c) for c in carry),
        t.cam, t.bf, t.bounds, t.scales, t.log_sf, t.coarse_radius,
        t.fine_th, kfi_target=jnp.float32(s.kfi_target_matches),
        is_stereo=jnp.asarray(True), th_depth=jnp.float32(s.th_depth),
        n_valid_frames=jnp.int32(W), med_override=jnp.float32(-1.0),
        n_slots=N_SLOTS, two_stage=two_stage, use_imu=use_imu)
    j_outs, j_assign, j_vis, j_fnd = (np.asarray(a) for a in j_out[:4])

    dev = "cpu"
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32)
    t_out = tws.window_track(
        local_map_from_numpy(type(lm)(*(np.asarray(a) for a in lm)), dev),
        torch.from_numpy(buf), *window_carry_from_numpy(carry, dev),
        pinhole_from_numpy(tuple(np.asarray(c) for c in t.cam), dev),
        f32(s.bf), torch.tensor(np.asarray(t.bounds, np.float32)),
        torch.tensor(np.asarray(t.scales, np.float32)),
        f32(t.log_sf), f32(t.coarse_radius), f32(t.fine_th),
        kfi_target=f32(s.kfi_target_matches),
        is_stereo=torch.tensor(True), th_depth=f32(s.th_depth),
        n_valid_frames=W, med_override=-1.0, n_slots=N_SLOTS,
        two_stage=two_stage, use_imu=use_imu)
    t_outs, t_assign, t_vis, t_fnd = (a.numpy() for a in t_out[:4])

    assert (j_outs[:, 17] > 0.5).all(), "every frame must track"
    np.testing.assert_allclose(t_outs[:, :16], j_outs[:, :16], atol=1e-4)
    for k in range(W):
        nj, nt = int(j_outs[k, 16]), int(t_outs[k, 16])
        assert abs(nj - nt) <= max(2, nj // 100), (k, nj, nt)
    assert np.array_equal(t_outs[:, 17:20], j_outs[:, 17:20])
    assert (t_assign == j_assign).mean() >= 0.99
    assert np.abs(t_vis - j_vis).sum() <= 0.01 * j_vis.sum()
    assert np.abs(t_fnd - j_fnd).sum() <= 0.01 * j_fnd.sum()
    np.testing.assert_allclose(t_out[4][0].numpy(), np.asarray(j_out[4][0]),
                               atol=1e-4)
    # the tracked poses are the true ones (the world frame is frame 0's)
    for k in range(W):
        rel = frames[k + 1].gt_pose_cw @ np.linalg.inv(frames[0].gt_pose_cw)
        assert np.abs(t_outs[k, :16].reshape(4, 4) - rel).max() < 2e-2


def test_gyro_delta_rotation_and_row_cache(jax_inputs):
    _, frames, _, _, _ = jax_inputs
    f = frames[2]
    for bg in (np.zeros(3), VP.BG_TRUE):
        np.testing.assert_allclose(
            twin.gyro_delta_rotation(f.imu_omega, f.imu_dt, bg),
            jwin.gyro_delta_rotation(f.imu_omega, f.imu_dt, bg), atol=1e-12)
    R0, _ = orbit_pose_wb(1 / FPS)
    R1, _ = orbit_pose_wb(2 / FPS)
    dR = twin.gyro_delta_rotation(f.imu_omega, f.imu_dt, VP.BG_TRUE)
    assert np.abs(dR - R0.T @ R1).max() < 5e-3
    # the packed row follows a changed prediction
    g = VP.frame_as(f, type(f))
    g.imu_dR_cam = np.eye(3)
    row0 = tws._pack_one_np(g, N_SLOTS).copy()
    assert tws._pack_one_np(g, N_SLOTS) is g._packed_row
    g.imu_dR_cam = dR.T
    row1 = tws._pack_one_np(g, N_SLOTS)
    # (descriptor bytes ride in the row as float32 bit patterns: compare
    # the nine prediction entries, then the whole row bit for bit)
    o = N_SLOTS * 13 + 2
    np.testing.assert_allclose(row0[o:o + 9], np.eye(3).ravel(), atol=0)
    np.testing.assert_allclose(row1[o:o + 9], dR.T.ravel(), atol=1e-7)
    np.testing.assert_array_equal(
        row1.view(np.uint32),
        jws._pack_one_np(_with_dR(f, dR.T), N_SLOTS).view(np.uint32))


def _with_dR(f, dR):
    g = VP.frame_as(f, type(f))
    g.imu_dR_cam = dR
    return g


def test_speculation_depth_capped_with_imu():
    system, _ = VP.build_lane("cpu", n_frames=2, n_points=200)
    assert twin.WindowedRunner(system, window=8).depth == 3
    assert twin.WindowedRunner(system, window=8, depth=2).depth == 2
    system.imu_solver = None
    assert twin.WindowedRunner(system, window=8).depth == twin.DEPTH == 4


# ---------------------------------------------------------------------------
# the runner's rebase restart
# ---------------------------------------------------------------------------

def _stereo_run(transform_at_commit: int | None):
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings as t_apply, synthetic_frames as t_frames)
    from snakeslam_tpu_torch.ops.imu import so3_exp_np
    from snakeslam_tpu_torch.system.settings import (InputType as TIT,
                                                     Settings as TSettings)
    from snakeslam_tpu_torch.system.slam import SlamSystem as TSystem
    from snakeslam_tpu_torch.utils.synthetic import (
        SyntheticWorld as TWorld, orbit_trajectory)

    n_frames = 48
    world = TWorld(n_points=1500, seed=7)
    s = TSettings()
    s.input_type = TIT.Stereo
    s.enable_imu = False
    s.feature_slots = 512
    s.th_depth = 25.0
    t_apply(world, s)
    system = TSystem(s, "cpu")
    lm = system.local_mapper
    lm.lba = None                     # the reduced back-end: cycles still
    lm.map_searcher = None            # dispatch and commit
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None
    frames = list(t_frames(
        world, orbit_trajectory(n_frames, radius=7.0,
                                arc=1.2 * n_frames / 400.0, fps=200.0),
        s, noise_px=0.3))
    for f in frames:
        f.timestamp = f.frame_id / 10.0   # dense keyframes
    runner = twin.WindowedRunner(system, window=4)
    smap = system.map
    log = dict(commits=0, stale=[], consumed=0, in_flight_at_transform=-1)

    inner_commit = lm.commit_deferred_checked

    def commit(tok):
        inner_commit(tok)
        log["commits"] += 1
        if log["commits"] == transform_at_commit:
            log["in_flight_at_transform"] = log["dispatched"] - log["consumed"]
            smap.transform(1.0, so3_exp_np(np.array([0.2, -0.1, 0.3])),
                           np.array([0.5, -1.0, 2.0]))

    lm.commit_deferred_checked = commit
    log["dispatched"] = 0
    inner_dispatch, inner_consume = runner._dispatch, runner._consume

    def dispatch(*a, **k):
        item, carry = inner_dispatch(*a, **k)
        item.basis = getattr(smap, "n_transforms", 0)
        log["dispatched"] += 1
        return item, carry

    def consume(item, *a, **k):
        log["consumed"] += 1
        if item.basis != getattr(smap, "n_transforms", 0):
            log["stale"].append(item.start)
        return inner_consume(item, *a, **k)

    runner._dispatch, runner._consume = dispatch, consume
    runner.run(frames)
    return system, runner, log, frames


def test_runner_restarts_chain_after_map_transform():
    base_sys, base_runner, base_log, frames = _stereo_run(None)
    assert base_runner.n_chain_restarts == 0 and base_log["commits"] >= 2
    system, runner, log, _ = _stereo_run(2)
    # windows were in flight when the transform landed ...
    assert log["in_flight_at_transform"] >= 1
    # ... and none of them was consumed after it
    assert log["stale"] == []
    assert runner.n_chain_restarts == 1
    assert system.map.n_transforms == 1
    assert len(system.tracker.trajectory) == len(frames)
    assert log["dispatched"] > base_log["dispatched"]   # they were redone
    ate, _, n = system.ate_against_gt(with_scale=False)
    ate0, _, _ = base_sys.ate_against_gt(with_scale=False)
    assert n == len(frames) and abs(ate - ate0) <= 0.1 * ate0 + 1e-4
