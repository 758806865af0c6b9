"""The JAX package's lanes on the CPU, traced step by step: the reference
traces the port's lanes are held against.

    python scripts/jax_lane_trace.py --lane mono_vi|mono_vi_small|loop
        [--print]

Runs one lane per process (``jax_enable_x64`` is process-wide) with the
settings of ``scripts/jax_mono_vi_reference.py`` (``mono_vi``:
``bench._build_mono_vi(7, 240)``, window 16, two-stage, x64 on;
``mono_vi_small``: that script's ``--small`` configuration, 80 frames,
window 8, x64 on, no ``finalize``) and ``scripts/jax_loop_reference.py``
(``loop``: ``bench._build_loop(7, 400, False)``, window 64, x64 off), the
JAX runner pinned to one window per blocking fetch.  The port's recorder
(``snakeslam_tpu_torch/utils/lane_trace.py``) wraps the JAX objects'
methods; nothing of the JAX package is edited.  The trace is stored under
``jax`` in ``snakeslam_tpu_torch/data/reference_traces.json`` (``--print``
prints it instead).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

SMALL_FRAMES = 80


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", required=True,
                    choices=["mono_vi", "mono_vi_small", "loop"])
    ap.add_argument("--print", action="store_true")
    args = ap.parse_args()
    x64 = args.lane != "loop"
    jax.config.update("jax_enable_x64", x64)

    import bench
    from snakeslam_tpu.loop import loop_closing
    from snakeslam_tpu.tracking import mono_init, windowed
    from snakeslam_tpu_torch.utils import lane_trace as LT

    windowed._InFlight.ready = lambda self: False   # one window per fetch
    if args.lane == "loop":
        system, frames = bench._build_loop(7, 400, False)
        runner = windowed.WindowedRunner(system, window=64)
    elif args.lane == "mono_vi":
        system, frames = bench._build_mono_vi(7, 240)
        runner = windowed.WindowedRunner(system, window=16, two_stage=True)
    else:
        from jax_mono_vi_reference import _build_small

        system, frames = _build_small(SMALL_FRAMES)
        runner = windowed.WindowedRunner(system, window=8)
    draw = "float64" if x64 else "float32"
    with_scale = args.lane != "loop"
    with LT.LaneTrace(system, mono_init, loop_closing) as rec:
        runner.run(frames)
        rec.summary("run", with_scale, draw)
        if args.lane != "mono_vi_small":
            system.finalize()
            rec.summary("final", with_scale, draw)
    rec.trace["lane"] = dict(name=args.lane, frames=len(frames), draw=draw)
    if args.print:
        print(json.dumps(rec.trace))
    else:
        LT.store("jax", args.lane, rec.trace)
        print(json.dumps(rec.trace["run"]), json.dumps(rec.trace.get("final")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
