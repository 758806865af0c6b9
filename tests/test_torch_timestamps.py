"""Frame times in the window rows: packed relative to a per-chain origin.

The window's keyframe-decision carry and its packed frame rows are
float32.  At unix times (~1.3e9 s, the timestamps of TUM, EuRoC and KITTI
recordings) float32 steps by 128 s, so a row that stores the absolute time
loses the half second the in-window time rule (``ts - last_kf_time >=
0.5``) needs.  The port packs times relative to ``t0 = 1024 *
floor(t_first / 1024)`` of the chain's first frame (``window_step.
time_origin``).

Held here, at an offset of 1024 * 1269531 s (1.3e9 s, a multiple of 1024)
against offset 0:

- the port's windowed run makes the same keyframe decisions and tracks the
  same poses at both offsets;
- one window of the port at the offset decides as the JAX package's
  window at offset 0 on the same inputs, while the JAX package's own
  window at the offset shows the fault: its time rule fires on other
  frames (the JAX package is the reference and is left as it is);
- below 1024 s the port packs the JAX package's rows bit for bit.
"""

import copy

import jax.numpy as jnp
import numpy as np
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
from snakeslam_tpu_torch.frontend import synthetic_source as t_src
from snakeslam_tpu_torch.models import window_step as tws
from snakeslam_tpu_torch.system import settings as t_settings
from snakeslam_tpu_torch.system.slam import SlamSystem as TSlamSystem
from snakeslam_tpu_torch.tracking import windowed as twin
from snakeslam_tpu_torch.utils import synthetic as t_syn
from snakeslam_tpu_torch.utils.convert import (
    local_map_from_numpy,
    pinhole_from_numpy,
)

OFFSET = 1024.0 * 1269531          # s: ~1.3e9, a multiple of 1024
W, N_SLOTS, P_SLOTS = 4, 512, 1024


def _settings(S, IT, world):
    s = S()
    s.input_type = IT.Stereo
    s.enable_imu = False
    s.feature_slots = N_SLOTS
    s.local_map_slots = P_SLOTS
    s.pin_local_map_bucket = True
    s.th_depth = 25.0
    return s


def test_time_origin():
    assert tws.time_origin(0.0) == 0.0
    assert tws.time_origin(1023.9) == 0.0
    assert tws.time_origin(OFFSET + 3.5) == OFFSET
    t = 1.3e9 + 1017.25
    assert 0 <= t - tws.time_origin(t) < 1024.0


def _port_run(offset):
    world = t_syn.SyntheticWorld(n_points=1500, seed=7)
    s = _settings(t_settings.Settings, t_settings.InputType, world)
    t_src.apply_world_to_settings(world, s)
    system = TSlamSystem(s, "cpu")
    frames = list(t_src.synthetic_frames(
        world, t_syn.orbit_trajectory(24, radius=7.0, arc=0.072, fps=200.0),
        s))
    for f in frames:
        f.timestamp = offset + f.frame_id / 5.0   # the time rule fires
    twin.WindowedRunner(system, window=W).run(frames)
    kfs = np.nonzero(system.map.kf_valid)[0]
    poses = np.stack([f.pose_cw for f in system.tracker.trajectory])
    return system.map.kf_frame_id[kfs], poses


def test_port_windowed_decisions_hold_at_unix_times():
    kf0, poses0 = _port_run(0.0)
    kf1, poses1 = _port_run(OFFSET)
    assert len(kf0) >= 3, "the time rule must insert keyframes"
    assert np.array_equal(kf0, kf1)
    assert np.array_equal(poses0, poses1)


def _jax_inputs(offset):
    world = SyntheticWorld(n_points=1500, seed=5)
    s = _settings(Settings, InputType, world)
    apply_world_to_settings(world, s)
    system = SlamSystem(s)
    frames = list(synthetic_frames(
        world, orbit_trajectory(W + 1, radius=7.0, arc=0.02, fps=200.0), s))
    for f in frames:
        f.timestamp = offset + f.frame_id / 5.0
    system.process_frame(frames[0])       # stereo initialization
    runner = WindowedRunner(system, window=W)
    lm, _, _ = runner._local_map()
    return system, runner, lm, frames[1:]


def _jax_need_kf(system, runner, lm, frames):
    t, s = system.tracker, system.s
    out = jws.window_track(
        lm, jnp.asarray(jws.pack_frames_np(frames, N_SLOTS)),
        jnp.asarray(t.last_frame.pose_cw, jnp.float32),
        jnp.asarray(t.velocity, jnp.float32),
        jnp.asarray(runner._initial_dec_state()), jnp.zeros((), bool),
        t.cam, t.bf, t.bounds, t.scales, t.log_sf, t.coarse_radius,
        t.fine_th, kfi_target=jnp.float32(s.kfi_target_matches),
        is_stereo=jnp.asarray(True), th_depth=jnp.float32(s.th_depth),
        n_valid_frames=jnp.int32(W), med_override=jnp.float32(-1.0),
        n_slots=N_SLOTS, two_stage=True)
    return np.asarray(out[0])[:, 18] > 0.5


def test_window_decisions_at_unix_times_against_the_jax_package():
    system0, runner0, lm0, frames0 = _jax_inputs(0.0)
    need0 = _jax_need_kf(system0, runner0, lm0, frames0)
    assert need0.any(), "the time rule must fire at offset 0"

    system, runner, lm, frames = _jax_inputs(OFFSET)
    # the JAX package's own window at the offset: float32 absolute times
    # are all one 128 s step apart or equal, the time rule misfires
    need_jax = _jax_need_kf(system, runner, lm, frames)
    assert not np.array_equal(need_jax, need0)

    # the port on the same inputs: its packing and its decision carry (the
    # runner's own method, on the JAX map's identical fields) relative to
    # the chain's time origin; copies keep the JAX frames' row caches
    t, s = system.tracker, system.s
    t0 = tws.time_origin(frames[0].timestamp)
    assert t0 == OFFSET
    buf = tws.pack_frames_np([copy.copy(f) for f in frames], N_SLOTS, t0=t0)
    dec = twin.WindowedRunner._initial_dec_state(runner, t0)
    f32 = lambda v: torch.tensor(np.float32(v))
    out = tws.window_track(
        local_map_from_numpy(type(lm)(*(np.asarray(a) for a in lm)), "cpu"),
        torch.from_numpy(buf),
        torch.from_numpy(np.asarray(t.last_frame.pose_cw, np.float32)),
        torch.from_numpy(np.asarray(t.velocity, np.float32)),
        torch.from_numpy(dec), torch.tensor(False),
        pinhole_from_numpy(tuple(np.asarray(c) for c in t.cam), "cpu"),
        f32(s.bf), torch.tensor(np.asarray(t.bounds, np.float32)),
        torch.tensor(np.asarray(t.scales, np.float32)),
        f32(t.log_sf), f32(t.coarse_radius), f32(t.fine_th),
        kfi_target=f32(s.kfi_target_matches), is_stereo=torch.tensor(True),
        th_depth=f32(s.th_depth),
        n_valid_frames=torch.tensor(W, dtype=torch.int32),
        med_override=f32(-1.0), n_slots=N_SLOTS)
    need_port = out[0].numpy()[:, 18] > 0.5
    assert np.array_equal(need_port, need0)


def test_rows_below_1024_s_are_the_jax_packages():
    _, _, _, frames = _jax_inputs(0.0)
    t0 = tws.time_origin(frames[0].timestamp)
    assert t0 == 0.0
    ours = tws.pack_frames_np([copy.copy(f) for f in frames], N_SLOTS, t0=t0)
    ref = jws.pack_frames_np(frames, N_SLOTS)
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))
