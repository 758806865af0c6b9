"""The JAX package's loop lane on a 4-device virtual CPU mesh: the reference
the port's sharded loop lane is gated against.

    python scripts/jax_multichip_reference.py [--frames 400] [--window 64]

The same run as ``scripts/jax_loop_reference.py`` (``bench._build_loop(7,
frames, False)``, the runner pinned to one window per blocking fetch, then
``finalize()``), with ``n_devices = 4`` in the settings and four virtual
XLA CPU devices (``--xla_force_host_platform_device_count=4``, set before
jax is imported): every ``GlobalBA.full_ba`` of the run (the loop
correction's and ``finalize``'s) goes through
``snakeslam_tpu/parallel/multichip.py::sharded_ba_step``.  The JAX package
is used as it is; only the runner's ``_InFlight.ready`` and
``bench._base_settings`` (to set ``n_devices``) are patched here.

Prints one JSON object: the fields of ``jax_loop_reference.py`` plus the
mesh size and the number of sharded full-BA calls (loop correction and
``finalize``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

N_DEVICES = 4

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + f" --xla_force_host_platform_device_count={N_DEVICES}"
    ).strip()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import bench  # noqa: E402
from snakeslam_tpu.optim import gba  # noqa: E402
from snakeslam_tpu.tracking import windowed  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--window", type=int, default=64)
    args = ap.parse_args()
    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(f"{len(jax.devices())} JAX devices, need "
                         f"{N_DEVICES} (XLA_FLAGS set before jax's import?)")

    windowed._InFlight.ready = lambda self: False   # one window per fetch
    base = bench._base_settings

    def sharded_settings():
        s = base()
        s.n_devices = N_DEVICES
        return s

    bench._base_settings = sharded_settings
    sharded_calls = []
    inner_sharded = gba.GlobalBA._sharded_full_ba

    def counted(self, problem, iterations):
        sharded_calls.append(int(iterations))
        return inner_sharded(self, problem, iterations)

    gba.GlobalBA._sharded_full_ba = counted

    system, frames = bench._build_loop(7, args.frames, False)
    lc = system.loop_closing
    if lc.gba._mesh is None or lc.gba._mesh.size != N_DEVICES:
        raise SystemExit("the loop closer's GlobalBA built no 4-device mesh")
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
               loop_correction_s=correct_s,
               sharded_full_ba_run=len(sharded_calls))
    t0 = time.perf_counter()
    system.finalize()
    out["finalize_s"] = time.perf_counter() - t0
    ate, _, _ = system.ate_against_gt(with_scale=False)
    out.update(keyframes_final=int(system.map.n_keyframes),
               points_final=int(system.map.n_points), ate_final_m=float(ate),
               sharded_full_ba_total=len(sharded_calls),
               sharded_full_ba_iterations=sharded_calls,
               n_devices=N_DEVICES, platform=jax.devices()[0].platform,
               device_count=len(jax.devices()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
