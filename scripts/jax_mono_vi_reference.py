"""The JAX package's monocular visual-inertial lane on the CPU: the reference
the port's mono-VI lane is gated against.

    python scripts/jax_mono_vi_reference.py [--frames 240] [--window 16]
        [--x64 1] [--small]

Builds ``bench._build_mono_vi(7, frames)`` (6000-point world, seed 7, the
excited orbit ``orbit_pose_wb`` at 20 fps, monocular, IMU at 200 Hz with
gyro bias [0.01, -0.008, 0.012], 1024 feature slots, 2048 pinned local-map
slots, LBA slots 32 / 8192 / 8), drives it through the JAX package's
``WindowedRunner`` (two-stage tracking) with its runner pinned to one window
per blocking fetch (its opportunistic multi-window consume makes the
schedule depend on timing), then calls ``finalize()``.  ``--small`` builds
the configuration of ``tests/test_windowed_vi.py`` instead (3000 points,
seed 5, LBA slots 24 / 4096 / 8, 10 fps; give ``--frames 120 --window 8``).
The JAX package is used as it is; only the runner's ``_InFlight.ready`` is
patched here.

``--x64 1`` (the default) turns ``jax_enable_x64`` on, as the package's own
tests do: the IMU state solver casts its host-sized problems to
``jnp.float64``, which is float64 only with that flag on; with ``--x64 0``
(as ``bench.py`` runs) the same code runs in float32.

Prints one JSON object: tracked frames, keyframes, points, Sim3 ATE and
alignment scale after the run and after ``finalize()``, the solver's stage
and gyro-bias error, the frames at which mono initialization, the gyro
stage and the gravity stage landed, the whole-map transforms, wall times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

BG_TRUE = np.array([0.01, -0.008, 0.012])


def _build_small(count, fps=10.0):
    from snakeslam_tpu.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu.system.settings import InputType, Settings
    from snakeslam_tpu.system.slam import SlamSystem
    from snakeslam_tpu.utils.imu_synthetic import orbit_pose_wb, synth_imu
    from snakeslam_tpu.utils.synthetic import SyntheticWorld

    s = Settings()
    s.input_type = InputType.Mono
    s.enable_imu = True
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.lba_cam_slots = 24
    s.lba_point_slots = 4096
    s.lba_obs_slots = 8
    world = SyntheticWorld(n_points=3000, seed=5)
    apply_world_to_settings(world, s)
    system = SlamSystem(s)

    def traj(n):
        for i in range(n):
            t = i / fps
            R, p = orbit_pose_wb(t)
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = p
            yield t, np.linalg.inv(T)

    imu = synth_imu(orbit_pose_wb, 0.0, count / fps, rate=200.0, bg=BG_TRUE,
                    gyro_noise=1e-4, acc_noise=1e-3)
    frames = list(synthetic_frames(world, traj(count), s, noise_px=0.3,
                                   imu=imu))
    return system, frames


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--x64", type=int, default=1)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", bool(args.x64))

    import bench
    from snakeslam_tpu.tracking import windowed

    windowed._InFlight.ready = lambda self: False   # one window per fetch
    if args.small:
        system, frames = _build_small(args.frames)
    else:
        system, frames = bench._build_mono_vi(7, args.frames)
    sol = system.imu_solver
    landed = dict(mono_init=None, gyro=None, gravity=None)

    inner_pf = system.process_frame

    def process_frame(frame):
        st = inner_pf(frame)
        if landed["mono_init"] is None and system.map.n_keyframes >= 2:
            landed["mono_init"] = int(frame.frame_id)
        return st

    system.process_frame = process_frame
    inner_um = sol.update_map

    def update_map():
        inner_um()
        newest = int(system.map.kf_frame_id[system.map.valid_keyframes()].max())
        if landed["gyro"] is None and sol.gyro_initialized:
            landed["gyro"] = newest
        if landed["gravity"] is None and sol.gravity_initialized:
            landed["gravity"] = newest

    sol.update_map = update_map

    t0 = time.perf_counter()
    runner = windowed.WindowedRunner(system, window=args.window,
                                     two_stage=True)
    runner.run(frames)
    wall = time.perf_counter() - t0
    ate, scale, _ = system.ate_against_gt(with_scale=True)
    out = dict(frames=len(frames), window=args.window, x64=bool(args.x64),
               small=bool(args.small),
               tracked=len(system.tracker.trajectory),
               keyframes=int(system.map.n_keyframes),
               points=int(system.map.n_points),
               sim3_ate_m=float(ate), align_scale=float(scale),
               vi_initialized=bool(sol.gyro_initialized
                                   and sol.gravity_initialized),
               stage=sol.stage.name,
               bg_err=float(np.abs(sol.bg - BG_TRUE).max()),
               init_scale=float(sol.init_scale),
               landed=landed,
               map_transforms=int(getattr(system.map, "n_transforms", 0)),
               windows=int(runner.n_device_calls), wall_s=wall)
    t0 = time.perf_counter()
    system.finalize()
    out["finalize_s"] = time.perf_counter() - t0
    ate, scale, _ = system.ate_against_gt(with_scale=True)
    out.update(keyframes_final=int(system.map.n_keyframes),
               points_final=int(system.map.n_points),
               sim3_ate_final_m=float(ate), align_scale_final=float(scale),
               bg_err_final=float(np.abs(sol.bg - BG_TRUE).max()),
               platform=jax.devices()[0].platform)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
