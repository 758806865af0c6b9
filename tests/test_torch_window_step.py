"""Port parity: one ``window_track`` call against the JAX ``window_track``.

The JAX package initializes a stereo map and builds the local-map snapshot,
the packed frame window and the carry; the same arrays, converted with
``snakeslam_tpu_torch.utils.convert``, go through the port's
``window_track`` (W = 4, n_slots = 512, P = 1024, two-stage).  Both run the
XLA-style robust pose refine, as the JAX package does off the TPU.

Tolerances: poses atol 1e-4 (f32 GN chains summed in another order),
inlier counts within max(2, 1%), keyframe decisions identical, per-feature
assignments identical on >= 99%.
"""

import numpy as np
import jax.numpy as jnp
import torch

from snakeslam_tpu.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu.models import window_step as jws
from snakeslam_tpu.system.settings import InputType, Settings
from snakeslam_tpu.system.slam import SlamSystem
from snakeslam_tpu.tracking.windowed import WindowedRunner
from snakeslam_tpu.utils.synthetic import SyntheticWorld, orbit_trajectory
from snakeslam_tpu_torch.models import window_step as tws
from snakeslam_tpu_torch.utils.convert import (
    local_map_from_numpy,
    pinhole_from_numpy,
    window_carry_from_numpy,
)

W, N_SLOTS, P_SLOTS = 4, 512, 1024


def _jax_window_inputs():
    world = SyntheticWorld(n_points=1500, seed=5)
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = N_SLOTS
    s.local_map_slots = P_SLOTS
    s.pin_local_map_bucket = True
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    system = SlamSystem(s)
    frames = list(synthetic_frames(
        world, orbit_trajectory(W + 1, radius=7.0, arc=0.02, fps=200.0), s))
    for f in frames:
        f.timestamp = f.frame_id / 5.0   # the time rule fires mid-window
    system.process_frame(frames[0])      # stereo initialization
    runner = WindowedRunner(system, window=W)
    lm, _, _ = runner._local_map()
    buf = jws.pack_frames_np(frames[1:], N_SLOTS)
    t = system.tracker
    carry = (np.asarray(t.last_frame.pose_cw, np.float32),
             np.asarray(t.velocity, np.float32),
             runner._initial_dec_state(), np.zeros((), bool))
    return system, lm, buf, carry


def test_window_track_parity():
    system, lm, buf, carry = _jax_window_inputs()
    t = system.tracker
    s = system.s
    scal = dict(kfi_target=float(s.kfi_target_matches), th_depth=s.th_depth)
    j_out = jws.window_track(
        lm, jnp.asarray(buf), *(jnp.asarray(c) for c in carry),
        t.cam, t.bf, t.bounds, t.scales, t.log_sf, t.coarse_radius,
        t.fine_th, kfi_target=jnp.float32(scal["kfi_target"]),
        is_stereo=jnp.asarray(True), th_depth=jnp.float32(scal["th_depth"]),
        n_valid_frames=jnp.int32(W), med_override=jnp.float32(-1.0),
        n_slots=N_SLOTS, two_stage=True)
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
        kfi_target=f32(scal["kfi_target"]),
        is_stereo=torch.tensor(True), th_depth=f32(scal["th_depth"]),
        n_valid_frames=W, med_override=-1.0, n_slots=N_SLOTS)
    t_outs, t_assign, t_vis, t_fnd = (a.numpy() for a in t_out[:4])

    assert t_outs.shape == (W, 24) and t_assign.shape == (W, N_SLOTS)
    assert t_assign.dtype == np.int16 and t_vis.dtype == np.int32
    assert (j_outs[:, 17] > 0.5).all(), "every frame must track"
    np.testing.assert_allclose(t_outs[:, :16], j_outs[:, :16], atol=1e-4)
    for k in range(W):
        nj, nt = int(j_outs[k, 16]), int(t_outs[k, 16])
        assert abs(nj - nt) <= max(2, nj // 100), (k, nj, nt)
    assert np.array_equal(t_outs[:, 17:20], j_outs[:, 17:20])
    assert j_outs[:, 18].sum() >= 1, "the keyframe decision must fire"
    assert (t_assign == j_assign).mean() >= 0.99
    assert np.abs(t_vis - j_vis).sum() <= 0.01 * j_vis.sum()
    assert np.abs(t_fnd - j_fnd).sum() <= 0.01 * j_fnd.sum()
    # the carry chains the next window with the same state
    np.testing.assert_allclose(t_out[4][0].numpy(), np.asarray(j_out[4][0]),
                               atol=1e-4)
    np.testing.assert_allclose(t_out[4][2].numpy(), np.asarray(j_out[4][2]),
                               rtol=1e-5, atol=1e-4)


def test_window_track_parity_tensor_padding_and_median_override():
    """The JAX signature's tensor inputs: ``n_valid_frames < W`` (the last
    row is tail padding: inactive, no keyframe, the carry passes through
    it) and a refreshed median depth ``med_override > 0``, both 0-d tensors
    on the port's side; the same tolerances as the parity test above."""
    system, lm, buf, carry = _jax_window_inputs()
    t = system.tracker
    s = system.s
    n_valid, med = W - 1, 2.0 * float(carry[2][8])
    j_out = jws.window_track(
        lm, jnp.asarray(buf), *(jnp.asarray(c) for c in carry),
        t.cam, t.bf, t.bounds, t.scales, t.log_sf, t.coarse_radius,
        t.fine_th, kfi_target=jnp.float32(s.kfi_target_matches),
        is_stereo=jnp.asarray(True), th_depth=jnp.float32(s.th_depth),
        n_valid_frames=jnp.int32(n_valid), med_override=jnp.float32(med),
        n_slots=N_SLOTS, two_stage=True)
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
        n_valid_frames=torch.tensor(n_valid, dtype=torch.int32),
        med_override=f32(med), n_slots=N_SLOTS)
    t_outs, t_assign, t_vis, t_fnd = (a.numpy() for a in t_out[:4])

    assert (j_outs[:n_valid, 17] > 0.5).all()
    np.testing.assert_allclose(t_outs[:, :16], j_outs[:, :16], atol=1e-4)
    for k in range(W):
        nj, nt = int(j_outs[k, 16]), int(t_outs[k, 16])
        assert abs(nj - nt) <= max(2, nj // 100), (k, nj, nt)
    assert np.array_equal(t_outs[:, 17:20], j_outs[:, 17:20])
    assert t_outs[n_valid, 18] == 0 and (t_assign[n_valid] == -1).all()
    assert (t_assign == j_assign).mean() >= 0.99
    assert np.abs(t_vis - j_vis).sum() <= 0.01 * j_vis.sum()
    assert np.abs(t_fnd - j_fnd).sum() <= 0.01 * j_fnd.sum()
    # the override reached the carry: a virtual-keyframe reset keeps the
    # median depth, so the slot holds it after the window
    t_dec, j_dec = t_out[4][2].numpy(), np.asarray(j_out[4][2])
    np.testing.assert_allclose(t_dec, j_dec, rtol=1e-5, atol=1e-4)
    assert t_dec[8] == j_dec[8] == np.float32(med)
    np.testing.assert_allclose(t_out[4][0].numpy(), np.asarray(j_out[4][0]),
                               atol=1e-4)
