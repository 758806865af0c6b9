"""Seeded monocular visual-inertial problems for checking the IMU path.

``build_lane`` makes the mono-VI lane: a monocular camera with an IMU on
the excited orbit ``orbit_pose_wb`` (accelerometer excitation makes metric
scale observable) in a synthetic world, feature-level frames that carry
their IMU samples, and a ``SlamSystem`` on the given device.  Its defaults
are the full-width configuration (6000 points, seed 7, 20 fps, IMU at
200 Hz with gyro bias [0.01, -0.008, 0.012], gyro noise 1e-4, accelerometer
noise 1e-3, 0.3 px feature noise, 1024 feature slots, 2048 pinned local-map
slots, LBA slots 32 / 8192 / 8, th_depth 25); ``SMALL`` holds the arguments
of the small configuration the CPU tests run.

``build_chain`` makes a keyframe chain for the IMU state solver's stages:
keyframes at ground-truth orbit poses in an under-scaled, tilted visual
frame (as a monocular map is before its visual-inertial initialization),
with the raw IMU samples of every interval bound as the solver's edges.

Used by the CPU parity tests (the same state carried into both packages)
and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu_torch.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap, \
    transform_pose_cw
from snakeslam_tpu_torch.ops.imu import so3_exp_np
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.utils.imu_synthetic import orbit_pose_wb, synth_imu
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld

BG_TRUE = np.array([0.01, -0.008, 0.012])
WINDOW = 16          # the full-width lane's window
SMALL = dict(n_frames=120, fps=10.0, n_points=3000, seed=5,
             lba_slots=(24, 4096, 8), th_depth=None, pin_bucket=False)
SMALL_WINDOW = 8


def lane_settings(world: SyntheticWorld, lba_slots=(32, 8192, 8),
                  th_depth: float | None = 25.0,
                  pin_bucket: bool = True) -> Settings:
    s = Settings()
    s.input_type = InputType.Mono
    s.enable_imu = True
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.lba_cam_slots, s.lba_point_slots, s.lba_obs_slots = lba_slots
    if th_depth is not None:
        s.th_depth = th_depth
    s.pin_local_map_bucket = pin_bucket
    apply_world_to_settings(world, s)
    return s


def orbit_pose_cw(t: float) -> np.ndarray:
    """World->camera pose on the orbit at time ``t`` (body == camera)."""
    R, p = orbit_pose_wb(t)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return np.linalg.inv(T)


def lane_frames(settings: Settings, world: SyntheticWorld, n_frames: int,
                fps: float, frame_cls=FrameData):
    """The lane's frames with their IMU samples; ``frame_cls`` lets a test
    rebuild the same frames as another package's frame class."""
    imu = synth_imu(orbit_pose_wb, 0.0, n_frames / fps, rate=200.0,
                    bg=BG_TRUE, gyro_noise=1e-4, acc_noise=1e-3)
    traj = ((i / fps, orbit_pose_cw(i / fps)) for i in range(n_frames))
    frames = list(synthetic_frames(world, traj, settings, noise_px=0.3,
                                   imu=imu))
    if frame_cls is not FrameData:
        frames = [frame_as(f, frame_cls) for f in frames]
    return frames


def frame_as(f: FrameData, cls):
    """``f`` as a frame of class ``cls`` (same fields, arrays copied)."""
    g = cls(frame_id=f.frame_id, timestamp=f.timestamp, uv=f.uv.copy(),
            octave=f.octave.copy(), angle=f.angle.copy(),
            descriptors=f.descriptors.copy(), right=f.right.copy(),
            depth=f.depth.copy(), gt_pose_cw=f.gt_pose_cw.copy())
    for k in ("imu_omega", "imu_acc", "imu_dt", "imu_t"):
        v = getattr(f, k, None)
        setattr(g, k, None if v is None else v.copy())
    return g


def build_lane(device, n_frames: int = 240, fps: float = 20.0,
               n_points: int = 6000, seed: int = 7,
               lba_slots=(32, 8192, 8), th_depth: float | None = 25.0,
               pin_bucket: bool = True):
    """(system, frames) of the mono-VI lane on ``device``."""
    from snakeslam_tpu_torch.system.slam import SlamSystem

    world = SyntheticWorld(n_points=n_points, seed=seed)
    settings = lane_settings(world, lba_slots, th_depth, pin_bucket)
    system = SlamSystem(settings, device)
    return system, lane_frames(settings, world, n_frames, fps)


# ---------------------------------------------------------------------------
# keyframe chain for the state solver's stages
# ---------------------------------------------------------------------------

CHAIN_SCALE = 2.7     # metric / visual: the visual map is under-scaled
CHAIN_TILT = np.array([0.3, -0.2, 0.1])   # visual frame = tilt * world


def build_chain(solver_cls, n_kf: int = 14, kf_dt: float = 0.5,
                seed: int = 3, pose_noise: float = 1e-3, **solver_kw):
    """A map of ``n_kf`` keyframes on the orbit, ``kf_dt`` apart, in a
    visual frame under-scaled by ``CHAIN_SCALE`` and rotated by
    ``CHAIN_TILT``, and a solver of class ``solver_cls`` holding the IMU
    edge of every interval (200 Hz, gyro bias ``BG_TRUE``).  Keyframe
    rotations carry ``pose_noise`` rad of seeded noise.

    Returns (settings, map, solver, keyframe ids in order)."""
    rng = np.random.default_rng(seed)
    s = Settings()
    s.input_type = InputType.Mono
    s.enable_imu = True
    smap = SlamMap(max_keyframes=32, max_points=64, max_features=8)
    sol = solver_cls(s, smap, **solver_kw)
    imu = synth_imu(orbit_pose_wb, 0.0, n_kf * kf_dt, rate=200.0,
                    bg=BG_TRUE, gyro_noise=1e-4, acc_noise=1e-3,
                    rng=np.random.default_rng(seed + 1))
    R_tilt = so3_exp_np(CHAIN_TILT)
    kfs = []
    n = 4
    for i in range(n_kf):
        t = i * kf_dt
        fd = FrameData(
            frame_id=i * 5, timestamp=t,
            uv=np.zeros((n, 2)), octave=np.zeros(n, np.int32),
            angle=np.zeros(n), descriptors=np.zeros((n, 32), np.uint8),
            right=np.full(n, -1.0), depth=np.full(n, -1.0))
        T = orbit_pose_cw(t)
        T[:3, :3] = so3_exp_np(rng.normal(scale=pose_noise, size=3)) \
            @ T[:3, :3]
        fd.pose_cw = transform_pose_cw(T, 1.0 / CHAIN_SCALE, R_tilt,
                                       np.zeros(3))
        k = smap.allocate_keyframe(fd)
        if kfs:
            smap.kf_prev[k] = kfs[-1]
            smap.kf_next[kfs[-1]] = k
            sel = (imu["t"] >= t - kf_dt - 1e-9) & (imu["t"] < t - 1e-9)
            fd.imu_omega = imu["omega"][sel]
            fd.imu_acc = imu["acc"][sel]
            fd.imu_dt = imu["dt"][sel]
            fd.imu_t = imu["t"][sel]
            sol.add_frame_samples(fd)
            sol.process_new_keyframe(k, kfs[-1])
        kfs.append(k)
    return s, smap, sol, kfs


# ---------------------------------------------------------------------------
# solver-sized problems: one keyframe chain as plain arrays
# ---------------------------------------------------------------------------

_EDGE_FILLS = dict(dR=np.eye(3), dv=np.zeros(3), dp=np.zeros(3),
                   J_R_bg=np.zeros((3, 3)), J_v_bg=np.zeros((3, 3)),
                   J_v_ba=np.zeros((3, 3)), J_p_bg=np.zeros((3, 3)),
                   J_p_ba=np.zeros((3, 3)))


def chain_arrays(n_kf: int = 12, K: int = 16, kf_dt: float = 0.5,
                 s_true: float = 2.0, bg=BG_TRUE,
                 ba=(0.04, -0.02, 0.05)) -> dict:
    """The fields of an ``ops.imu.ImuChain`` as numpy arrays: ``n_kf``
    keyframes at the orbit's true states, positions and velocities
    under-scaled by ``s_true``, every edge preintegrated at zero bias from
    200 Hz samples that carry the biases ``bg`` / ``ba``, padded to ``K``
    node slots (``edge_valid`` masks the pad).  ``v_true`` (n_kf, 3) rides
    along for checks."""
    from snakeslam_tpu_torch.ops.imu import preintegrate_np
    from snakeslam_tpu_torch.utils.imu_synthetic import true_state

    data = synth_imu(orbit_pose_wb, 0.0, n_kf * kf_dt, rate=200.0,
                     bg=np.asarray(bg), ba=np.asarray(ba))
    states = [true_state(orbit_pose_wb, k * kf_dt) for k in range(n_kf)]
    pre = []
    for k in range(n_kf - 1):
        sel = ((data["t"] >= k * kf_dt - 1e-9)
               & (data["t"] < (k + 1) * kf_dt - 1e-9))
        pre.append(preintegrate_np(data["omega"][sel], data["acc"][sel],
                                   data["dt"][sel], np.zeros(3),
                                   np.zeros(3)))
    E = n_kf - 1

    def pad(a, fill, n):
        out = np.tile(fill, (n,) + (1,) * np.ndim(fill))
        out[:len(a)] = a
        return out

    v = np.stack([s[2] for s in states])
    out = dict(
        R=pad(np.stack([s[0] for s in states]), np.eye(3), K),
        p=pad(np.stack([s[1] for s in states]) / s_true, np.zeros(3), K),
        v=pad(v / s_true, np.zeros(3), K),
        dt=pad(np.array([float(x.dt) for x in pre]), np.float64(1.0), K - 1),
        edge_valid=np.arange(K - 1) < E, v_true=v)
    for name, fill in _EDGE_FILLS.items():
        out[name] = pad(np.stack([getattr(x, name) for x in pre]), fill,
                        K - 1)
    return out
