"""The JAX package's loop lane on the CPU: the reference the port's loop lane
is gated against.

    python scripts/jax_loop_reference.py [--frames 400] [--window 64]

Builds ``bench._build_loop(7, frames, False)`` (60000-point world, seed 7,
an outward full orbit at 200 fps, stereo, 1024 feature slots, 4096 pinned
local-map slots, LBA slots 32 / 8192 / 8, ``th_map`` 400), drives it
through the JAX package's ``WindowedRunner`` with its runner pinned to one
window per blocking fetch (its opportunistic multi-window consume makes the
schedule depend on timing), then calls ``finalize()``.  The JAX package is
used as it is; only the runner's ``_InFlight.ready`` is patched here.

Prints one JSON object: tracked frames, keyframes, points, ATE (SE3,
camera centres), loops closed and the wall time after the run; keyframes,
points and ATE after ``finalize()`` and its wall time; the loop
corrections' wall times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import bench  # noqa: E402
from snakeslam_tpu.tracking import windowed  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--window", type=int, default=64)
    args = ap.parse_args()

    windowed._InFlight.ready = lambda self: False   # one window per fetch
    system, frames = bench._build_loop(7, args.frames, False)
    lc = system.loop_closing
    correct_s = []
    inner = lc._correct_loop

    def timed_correct(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            correct_s.append(time.perf_counter() - t0)

    lc._correct_loop = timed_correct
    t0 = time.perf_counter()
    windowed.WindowedRunner(system, window=args.window).run(frames)
    wall = time.perf_counter() - t0
    ate, _, _ = system.ate_against_gt(with_scale=False)
    out = dict(frames=len(frames), window=args.window,
               tracked=len(system.tracker.trajectory),
               keyframes=int(system.map.n_keyframes),
               points=int(system.map.n_points), ate_m=float(ate),
               loops_closed=int(lc.n_loops_closed), wall_s=wall,
               loop_correction_s=correct_s)
    t0 = time.perf_counter()
    system.finalize()
    out["finalize_s"] = time.perf_counter() - t0
    ate, _, _ = system.ate_against_gt(with_scale=False)
    out.update(keyframes_final=int(system.map.n_keyframes),
               points_final=int(system.map.n_points), ate_final_m=float(ate),
               platform=jax.devices()[0].platform)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
