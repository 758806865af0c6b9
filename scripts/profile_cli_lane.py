"""Where the dataset CLI's per-frame path spends its time on the GPU.

    python scripts/profile_cli_lane.py [--frames 60] [--profiled 10]

Writes the first ``--frames`` frames of ``chip_smoke.py``'s CLI lane (the
rendered TUM-RGBD sequence of ``utils/tum_fixture.py``, 640x480) into a
temporary directory, builds ``Input`` and ``SlamSystem`` on the card from a
copy of ``configs/tum.ini`` as the CLI does, and drives the frames through
``SlamSystem.process_frame``: all of them under cProfile (host), the last
``--profiled`` of them again under torch.profiler (device).  Prints one
JSON object: host ms a frame for ORB and for tracking, the top host
functions by own time and by cumulative time, the device kernels and
runtime calls per frame (launches, synchronizing calls, copies), the
device's busy share of the profiled frames and the top device kernels by
count.  The tracking steps run as captured CUDA graphs (``utils/
graphs.py``): a replay shows as one ``cudaGraphLaunch`` among the runtime
calls.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from snakeslam_tpu_torch.frontend.input import Input  # noqa: E402
from snakeslam_tpu_torch.system.settings import Settings  # noqa: E402
from snakeslam_tpu_torch.system.slam import SlamSystem  # noqa: E402
from snakeslam_tpu_torch.utils import tum_fixture as TF  # noqa: E402


def _top(prof: cProfile.Profile, key: str, n: int = 25) -> list:
    st = pstats.Stats(prof, stream=io.StringIO())
    st.sort_stats(key)
    rows = []
    for func in st.fcn_list[:n]:
        cc, nc, tt, ct, _ = st.stats[func]
        rows.append([f"{Path(func[0]).name}:{func[1]}:{func[2]}", nc,
                     round(tt, 4), round(ct, 4)])
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--profiled", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cli_lane: needs a CUDA device")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        TF.write_tum_fixture(tmp / "tum", TF.lane_world(),
                             TF.lane_trajectory(args.frames))
        s = Settings.from_ini(TF.copy_config(tmp / "tum.ini"))
        s.set_default_parameters_for_dataset()
        s.dataset.dataset_dir = str(tmp / "tum")
        inp = Input(s, dataset_root=str(tmp / "tum"), device=dev)
        frames = list(inp)          # ORB for every frame, first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames_again = [inp.process_raw(r) for r in
                        list(inp.dataset)[:args.profiled]]
        torch.cuda.synchronize()
        orb_ms = (time.perf_counter() - t0) * 1e3 / args.profiled
        system = SlamSystem(s, dev)
        head = frames[:-args.profiled]
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for f in head:
            system.process_frame(f)
        torch.cuda.synchronize()
        prof.disable()
        track_ms = (time.perf_counter() - t0) * 1e3 / max(len(head), 1)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as tp:
            for f in frames[-args.profiled:]:
                system.process_frame(f)
            torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
        del frames_again
    ev = tp.key_averages()
    kernels = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n = args.profiled
    runtime = {e.key: e.count / n for e in ev
               if e.key.startswith(("cuda", "aten::_local_scalar_dense",
                                    "aten::item", "aten::copy_"))}
    out = dict(
        device=torch.cuda.get_device_name(0), frames=args.frames,
        orb_ms_per_frame=orb_ms, tracking_ms_per_frame=track_ms,
        keyframes=system.map.n_keyframes,
        tracked=len(system.tracker.trajectory),
        host_top_tottime=_top(prof, "tottime"),
        host_top_cumulative=_top(prof, "cumulative"),
        profiled_frames=n, profiled_wall_s=prof_wall,
        device_busy_share=busy_us / 1e6 / prof_wall,
        kernels_per_frame=sum(e.count for e in kernels) / n,
        runtime_calls_per_frame=runtime,
        top_kernels_by_count=sorted(
            ([e.key[:80], e.count / n, e.self_device_time_total / e.count]
             for e in kernels), key=lambda r: -r[1])[:20],
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
