"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the process
exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; no CUDA device is an error;
  2. build: the pose kernel from snakeslam_tpu_torch/csrc with nvcc;
  3. kernel: the CUDA pose kernel against its plain PyTorch version on the
     card at N = 512 and 1024, stereo and mono, bit-identical on a rerun,
     and timed (median of per-call CUDA-event times after a warm-up);
  4. slice: the smooth stereo lane at full width (6000-point world, seed 7,
     400 frames, 1024 feature slots, 2048 pinned local-map slots, window
     128, two-stage) through WindowedRunner on the card, with launch counts
     reset just before the run and read just after;
  5. CPU against GPU: the first 64 frames, window 16, dense keyframes,
     through the port on both devices.

The line before the last is one JSON object with the kernels' names,
routes, launch counts, errors and times; the last line is the result.
Imports only the port, numpy and torch.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from snakeslam_tpu_torch.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu_torch.ops import pose_fused as PF
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.system.slam import SlamSystem
from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
from snakeslam_tpu_torch.utils.pose_problems import pose_problem
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld, orbit_trajectory

POSE_ATOL = 2e-4          # tests/test_pose_pallas.py tolerances
TIMED_CALLS = 100


def phase(name: str, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_calls_us(fn, n: int = TIMED_CALLS, warmup: int = 10) -> float:
    """Median per-call device time in microseconds over ``n`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def kernel_phase(dev) -> dict:
    """Kernel vs plain version at the window's slot counts; returns the
    worst error and the N = 1024 stereo times."""
    worst = 0.0
    timing = {}
    for n in (512, 1024):
        for stereo in (True, False):
            args, T_gt = pose_problem(3 + n, n, stereo, dev)
            batched = [t[None] for t in args[:6]] + list(args[6:])
            for outer, inner in ((1, 3), (2, 2)):
                kw = dict(outer_iters=outer, inner_iters=inner)
                T, inl, cnt = PF.pose_refine_fused(*args, **kw)
                T2, inl2, cnt2 = PF.pose_refine_fused(*args, **kw)
                Tr, ir, nr = PF.pose_refine_fused_reference(*batched, **kw)
                torch.cuda.synchronize()
                check(torch.equal(T, T2) and torch.equal(inl, inl2)
                      and int(cnt) == int(cnt2), "kernel rerun not bit-identical")
                err = (T - Tr[0]).abs().max().item()
                agree = (inl == ir[0]).float().mean().item()
                c, cr = int(cnt), int(nr[0])
                worst = max(worst, err)
                check(err <= POSE_ATOL, f"pose error {err} at N={n}")
                check(agree > 0.99, f"inlier agreement {agree} at N={n}")
                check(abs(c - cr) <= max(3, cr // 100),
                      f"inlier counts {c} vs {cr} at N={n}")
                check(np.linalg.norm(T.cpu().numpy()[:3, 3] - T_gt[:3, 3])
                      < 2e-3, f"kernel missed the ground truth at N={n}")
            kw = dict(outer_iters=2, inner_iters=2)
            us = time_calls_us(lambda: PF.pose_refine_fused(*args, **kw))
            us_plain = time_calls_us(
                lambda: PF.pose_refine_fused_reference(*batched, **kw))
            phase("kernel", n=n, stereo=stereo, max_abs_err=worst,
                  kernel_us=us, plain_us=us_plain)
            if n == 1024 and stereo:
                timing = dict(ms=us / 1e3, plain_ms=us_plain / 1e3)
    return dict(max_abs_err=worst, **timing)


def smooth_settings(world) -> Settings:
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.pin_local_map_bucket = True
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    return s


def smooth_lane(seed: int, count: int, dev, dense: bool = False):
    world = SyntheticWorld(n_points=6000, seed=seed)
    s = smooth_settings(world)
    system = SlamSystem(s, dev)
    frames = list(synthetic_frames(
        world, orbit_trajectory(count, radius=7.0, arc=1.2 * count / 400.0,
                                fps=200.0),
        s, noise_px=0.3))
    if dense:
        for f in frames:
            f.timestamp = f.frame_id / 10.0
    return system, frames


def slice_phase(dev) -> int:
    # warm-up as the bench does: dense keyframes exercise every path once
    system, frames = smooth_lane(123, 48, dev, dense=True)
    WindowedRunner(system, window=128).run(frames)
    torch.cuda.synchronize()

    system, frames = smooth_lane(7, 400, dev)
    runner = WindowedRunner(system, window=128)
    PF.LAUNCHES = 0
    t0 = time.perf_counter()
    runner.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PF.LAUNCHES
    tracked = len(system.tracker.trajectory)
    ate, _, _ = system.ate_against_gt(with_scale=False)
    phase("slice", frames=len(frames), tracked=tracked,
          keyframes=system.map.n_keyframes, points=system.map.n_points,
          ate_m=ate, wall_s=wall, fps=tracked / wall, launches=launches,
          device_calls=runner.n_device_calls)
    check(tracked == 400, f"tracked {tracked} of 400 frames")
    check(4 <= system.map.n_keyframes <= 6,
          f"{system.map.n_keyframes} keyframes, expected 4 to 6")
    check(ate <= 3.0e-3, f"ATE {ate} m above 3.0 mm")
    check(launches == 2 * runner.window * runner.n_device_calls,
          f"{launches} kernel launches for {runner.n_device_calls} windows")
    return launches


def _centres(system) -> dict:
    return {f.frame_id: np.linalg.inv(system.frame_pose_global(f))[:3, 3]
            for f in system.tracker.trajectory}


def cpu_gpu_phase(dev):
    out = {}
    for d in ("cpu", dev):
        system, frames = smooth_lane(7, 400, d, dense=True)
        WindowedRunner(system, window=16).run(frames[:64])
        out[str(d)] = system
    c, g = out["cpu"], out[str(dev)]
    cc, gc = _centres(c), _centres(g)
    diff = max(np.linalg.norm(cc[k] - gc[k]) for k in cc) if cc else np.inf
    phase("cpu_vs_gpu", tracked_cpu=len(c.tracker.trajectory),
          tracked_gpu=len(g.tracker.trajectory),
          keyframes_cpu=c.map.n_keyframes, keyframes_gpu=g.map.n_keyframes,
          max_centre_diff_m=float(diff))
    check(len(c.tracker.trajectory) == len(g.tracker.trajectory) == 64,
          "CPU and GPU tracked counts differ")
    check(cc.keys() == gc.keys(), "CPU and GPU tracked different frames")
    check(c.map.n_keyframes == g.map.n_keyframes,
          "CPU and GPU keyframe counts differ")
    check(diff < 1e-3, f"camera centres differ by {diff} m")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    phase("build", seconds=PF.build(force=True))
    kern = kernel_phase(dev)
    launches = slice_phase(dev)
    cpu_gpu_phase(dev)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "pose_refine_fused",
        "route": "cuda",
        "source": "snakeslam_tpu_torch/csrc/pose_refine.cu",
        "replaces": "snakeslam_tpu/ops/pose_pallas.py:258",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
