"""Where the port's lanes spend their time on the GPU.

    python scripts/profile_torch_slice.py [--lane smooth|pixels]
                                          [--frames 400] [--window 128]

``smooth`` runs chip_smoke.py's smooth lane (6000-point world, seed 7, 1024
feature slots, 2048 pinned local-map slots, two-stage, the full keyframe
back-end; frames and window from the options); ``pixels`` runs its pixels
lane (160 rendered 752x480 stereo pairs, chunk and window 32, reduced
back-end; the options do not apply) and also times the front-end alone on
one chunk (median of CUDA-event times).  Each lane runs once to warm up and
once under torch.profiler; the script prints one JSON object: wall time,
summed device kernel time, the device's busy share of the wall, the launch
counts (device kernels, and the host's launch calls a frame: kernel and
CUDA-graph launches, copies), the compiled programs' replays
(``utils/graphs.py``), the top device kernels by total time, and the
keyframe cycle's share: the device kernels launched while the local
mapper dispatched or committed a keyframe cycle (triangulation, fusion,
local BA and the back-end queues it feeds), with their count and device
time, and the same
for each stage's dispatch (triangulation, fusion, local BA), and the pose
and FAST kernels' device time per launch from the profile.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (card_line, pixels_run, render_pixels_lane,  # noqa: E402
                        smooth_lane, time_calls_us)
from snakeslam_tpu_torch.frontend.pixels import stereo_frontend_batch  # noqa: E402
from snakeslam_tpu_torch.ops import orb_kernels as OK  # noqa: E402
from snakeslam_tpu_torch.ops import pose_fused as PF  # noqa: E402
from snakeslam_tpu_torch.tracking.windowed import WindowedRunner  # noqa: E402
from snakeslam_tpu_torch.utils import graphs  # noqa: E402

# host runtime calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _frontend_us(lane, dev) -> float:
    """Median device time of stereo_frontend_batch on one chunk (32 pairs,
    already on the card)."""
    s = lane["settings"]
    L = torch.from_numpy(lane["L"][:32]).to(dev)
    R = torch.from_numpy(lane["R"][:32]).to(dev)
    return time_calls_us(lambda: stereo_frontend_batch(
        L, R, bf=float(s.bf), n_features=int(s.fd_features),
        levels=int(s.fd_levels), scale_factor=float(s.fd_scale_factor),
        threshold=float(s.fd_ini_th_fast),
        relaxed=bool(s.fd_relaxed_stereo)), n=20, warmup=3)


KF_CYCLE = "keyframe_cycle"


def _annotated(fn, name):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _kernels_under(events, name):
    """Device kernels launched by host ops inside ``name`` ranges: the
    number of ranges, the kernels' count and their summed device time
    (us)."""
    ranges, count, us = 0, 0, 0.0
    seen = set()

    def walk(ev):
        nonlocal count, us
        if id(ev) in seen:
            return
        seen.add(id(ev))
        for k in getattr(ev, "kernels", []):
            count += 1
            us += k.duration
        for child in ev.cpu_children:
            walk(child)

    for ev in events:
        # the host-side range (each annotation also has a device-side one)
        if (ev.name == name
                and ev.device_type == torch.autograd.DeviceType.CPU):
            ranges += 1
            walk(ev)
    return ranges, count, us


def _device_us_per_launch(events, needle):
    """Mean device time (us) of the kernels whose name holds ``needle``,
    or None when the profile has none."""
    hits = [e for e in events if needle in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / n if n else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", choices=("smooth", "pixels"), default="smooth")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: no CUDA device")
    dev = torch.device("cuda", 0)
    extra = {}
    if args.lane == "pixels":
        lane = render_pixels_lane()
        system, frames, runner = pixels_run(lane, dev)
        runner.run(frames)
        torch.cuda.synchronize()
        extra["frontend_us_per_chunk"] = _frontend_us(lane, dev)
        system, frames, runner = pixels_run(lane, dev)
    else:
        system, frames = smooth_lane(123, 48, dev, dense=True)
        WindowedRunner(system, window=args.window).run(frames)
        torch.cuda.synchronize()
        system, frames = smooth_lane(7, args.frames, dev)
        runner = WindowedRunner(system, window=args.window)
    # mark the keyframe cycle's host ranges: kernels launched inside them
    # are the cycle's share
    lm = system.local_mapper
    for name in ("dispatch_deferred", "commit_deferred"):
        setattr(lm, name, _annotated(getattr(lm, name), KF_CYCLE))
    # and each stage's dispatch inside it
    stages = {"triangulation": (lm, "_tri_dispatch"),
              "fusion": (lm.map_searcher, "dispatch"),
              "lba": (lm.lba, "dispatch")}
    for stage, (obj, name) in stages.items():
        if obj is not None:
            setattr(obj, name, _annotated(getattr(obj, name),
                                          f"{KF_CYCLE}.{stage}"))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    PF.LAUNCHES = 0
    OK.FAST_LAUNCHES = 0
    g0 = {p.name: p.replays for p in graphs.programs()}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: the keyframe-cycle annotation also shows up with
    # a device-side range, which is not a kernel
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(KF_CYCLE)]
    if not events:
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0) > 0
                  and not e.key.startswith(KF_CYCLE)]
    runtime = {e.key: e.count for e in prof.key_averages()
               if e.key in LAUNCH_CALLS}
    replays = {p.name: p.replays - g0.get(p.name, 0)
               for p in graphs.programs() if p.replays > g0.get(p.name, 0)}
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:args.top]
    fevents = prof.events()
    _, cycle_kernels, cycle_us = _kernels_under(fevents, KF_CYCLE)
    per_stage = {}
    for stage in stages:
        n, k, us = _kernels_under(fevents, f"{KF_CYCLE}.{stage}")
        per_stage[stage] = {"dispatches": n, "device_kernels": k,
                            "device_ms": us / 1e3}
    print(card_line())
    print(json.dumps({
        "lane": args.lane, "frames": len(frames),
        "tracked": len(system.tracker.trajectory),
        "wall_s": wall, "device_kernel_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall,
        "device_kernels": n_kernels,
        "device_kernels_per_frame": n_kernels / len(frames),
        "host_launch_calls": runtime,
        "host_launch_calls_per_frame": sum(runtime.values()) / len(frames),
        "graph_replays": replays,
        "pose_kernel_launches": PF.LAUNCHES,
        "fast_kernel_launches": OK.FAST_LAUNCHES,
        "pose_kernel_device_us_per_launch": _device_us_per_launch(
            events, "pose_refine_kernel"),
        "fast_kernel_device_us_per_launch": _device_us_per_launch(
            events, "fast_kernel"),
        "device_calls": runner.n_device_calls,
        "keyframes": system.map.n_keyframes,
        "kf_cycle_device_kernels": cycle_kernels,
        "kf_cycle_device_s": cycle_us / 1e6,
        "kf_cycle_share_of_device_time": cycle_us / max(dev_us, 1e-9),
        "kf_cycle_share_of_kernels": cycle_kernels / max(n_kernels, 1),
        "kf_cycle_stages": per_stage,
        **extra,
        "top": [{"name": e.key[:80], "count": e.count,
                 "total_ms": e.self_device_time_total / 1e3}
                for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
