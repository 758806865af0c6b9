"""The readings the limits of ``correct`` are set from.

    python3 slambench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control 1] [--loop-offset-m 0.3] \
        [--numbers a,b,...]

In one process (one set-up's warm-up serves every seed: the shapes are the
seed's, not its values), for each seed: the cell's sequences, a window of
``--seconds`` at the cell's own load, then the judge's numbers for the
program's answers and, with ``--control 1``, for the control's (the
reference in the program's place, computed in bfloat16).  A window that
finished no session is judged on its session in flight
(``harness.judge_in_flight``).  With ``--loop-offset-m`` every loop
correction is planted wrong where it is produced: the measured
similarity's translation moved by that many metres along x before the
correction applies it.  One JSON line a seed, with
each number's worst case, median, 99th percentile and mean (the judge's
``measure``): the numbers the cell's limits list, or those ``--numbers``
names (a new cell before it has limits; with neither, every built-in
number that has something to read).  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def stats(x) -> dict:
    x = np.asarray(x, dtype=np.float64)
    if not len(x):
        return {}
    return {"max": float(x.max()), "p99": float(np.percentile(x, 99)),
            "p50": float(np.median(x)), "mean": float(x.mean()),
            "n": int(len(x))}


def plant_loop_offset(metres: float):
    """Every loop correction applies its similarity with the translation
    moved by ``metres`` along x."""
    from snakeslam_tpu_torch.loop.loop_closing import LoopClosing
    inner = LoopClosing._correct_loop

    def correct(self, kf, cand, s, R, t, pairs):
        t = np.asarray(t, np.float64) + np.array([metres, 0.0, 0.0])
        return inner(self, kf, cand, s, R, t, pairs)
    LoopClosing._correct_loop = correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--loop-offset-m", type=float, default=0.0)
    ap.add_argument("--numbers", default="")
    args = ap.parse_args(argv)
    from harness import (Runner, cleanup, judge_in_flight, load_cell,
                         run_window, workdir_for)
    from reference.judge import measure

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.loop_offset_m:
        plant_loop_offset(args.loop_offset_m)
    numbers = args.numbers.split(",") if args.numbers else None
    warmed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = workdir_for(cell.name)
        try:
            t0 = time.perf_counter()
            runner = Runner(cell, seed, "cuda", workdir, numbers)
            if not warmed:
                runner.warm_up()
                warmed = True
            t_setup = time.perf_counter() - t0
            rec = run_window(runner, args.seconds)
            in_flight = judge_in_flight(runner, rec)
            t1 = time.perf_counter()

            def detail(dtype):
                got = measure(rec, cell.config, runner.seqs[0].images or None,
                              dtype, "cuda", seed, runner.truth,
                              runner.numbers or None, cell, runner)
                return {k: stats(v) for k, v in got.items()}
            line = {"seed": seed, "setup_s": t_setup,
                    "loop_offset_m": args.loop_offset_m,
                    "frames": len(rec.frames),
                    "lost": sum(f.pose is None for f in rec.frames),
                    "sessions": rec.sessions_done,
                    "in_flight_judged": in_flight,
                    # keyframes, points, loops closed of each finished
                    # session's map
                    "maps": [[len(m.kf_ids), len(m.pt_ids), m.loops]
                             for m in rec.maps],
                    "program": detail(torch.float64)}
            line["judge_s"] = time.perf_counter() - t1
            if args.control:
                line["control"] = detail(torch.bfloat16)
            print(json.dumps(line), flush=True)
        finally:
            cleanup(workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
