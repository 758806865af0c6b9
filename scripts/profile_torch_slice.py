"""Where the port's stereo tracking slice spends its time on the GPU.

    python scripts/profile_torch_slice.py [--frames 400] [--window 128]

Runs the smooth lane of chip_smoke.py (6000-point world, seed 7, 1024
feature slots, 2048 pinned local-map slots, two-stage) once to warm up and
once under torch.profiler, then prints one JSON object: wall time, summed
device kernel time, the device's busy share of the wall, the launch count,
and the top device kernels by total time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import card_line, smooth_lane  # noqa: E402
from snakeslam_tpu_torch.ops import pose_fused as PF  # noqa: E402
from snakeslam_tpu_torch.tracking.windowed import WindowedRunner  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: no CUDA device")
    dev = torch.device("cuda", 0)
    system, frames = smooth_lane(123, 48, dev, dense=True)
    WindowedRunner(system, window=args.window).run(frames)
    torch.cuda.synchronize()

    system, frames = smooth_lane(7, args.frames, dev)
    runner = WindowedRunner(system, window=args.window)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    PF.LAUNCHES = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]
    print(card_line())
    print(json.dumps({
        "frames": args.frames, "tracked": len(system.tracker.trajectory),
        "wall_s": wall, "device_kernel_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall,
        "device_kernels": n_kernels, "pose_kernel_launches": PF.LAUNCHES,
        "top": [{"name": e.key[:80], "count": e.count,
                 "total_ms": e.self_device_time_total / 1e3}
                for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
