"""The benchmark of snakeslam_tpu_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's sequences from the seed and warms the program up
on a throw-away system; the window then runs sessions back to back for
``--seconds``; the run prints the end-to-end metrics (``--trace 0``) or
the per-layer metrics read from probes and a device trace of the window
(``--trace 1``), judges what the window produced against the reference,
and prints one JSON line last on standard output.  No card, or fewer than
the cell asks for: exit 2 and no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "snakeslam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="slambench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every sample (linear between ranks)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(cell, rec, seconds: float, setup_s: float) -> dict:
    done = [f for f in rec.frames if f.pose is not None]
    out = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "fps":
            v = len(done) / seconds
        elif name == "frame_ms_p95":
            lat = [(f.t_out - f.t_start) * 1e3 for f in rec.frames
                   if f.t_start is not None]
            print(f"frame_ms median {percentile(lat, 50)!r} p95 "
                  f"{percentile(lat, 95)!r} samples {len(lat)}",
                  file=sys.stderr)
            v = percentile(lat, 95)
        else:
            raise KeyError(f"no end-to-end metric {name!r} in this harness")
        out[name] = {"value": v, "unit": m["unit"]}
    return out


class Context:
    """What a per-layer reader reads: the window's probes, the recorder,
    the launch tallies, graph captures and the device trace summary."""

    def __init__(self, probes, rec, launches, captures, trace):
        self.probes = probes
        self.rec = rec
        self.launches = launches
        self.graph_captures = captures
        self.trace = trace

    def probe(self, spec):
        return self.probes[spec]


def device_info(trace_summary=None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1,
         "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace_summary is not None:
        d["busy_s"] = trace_summary["busy_s"]
        d["window_s"] = trace_summary["window_s"]
    return d


def breakdown(summary) -> dict:
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    idle = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s[0]] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}


def graph_captures() -> int:
    from snakeslam_tpu_torch.utils import graphs
    return sum(v["captures"] for v in graphs.stats().values())


def judge(cell, rec, runner, seed: int, device: str = "cuda"):
    """(correct, the compared numbers with their limits); the reference's
    solves run on ``device``."""
    from reference.judge import limits_faults, readings

    # the numbers the cell's limits list, and no other
    got = readings(rec, cell.config, runner.seqs[0].images or None,
                   device=device, seed=seed,
                   loops_per_session=cell.traffic.get("loops_per_session", 0),
                   truth=runner.truth, numbers=runner.numbers, cell=cell,
                   runner=runner)
    limits = cell.traffic.get("limits", {})
    checks = {name: {"value": v, "limit": limits[name]}
              for name, v in got.items()}
    # a number with nothing to read fails, and so does a cell whose limits
    # break the rule every cell keeps (none, or none over frames or maps)
    faults = limits_faults(limits)
    for fault in faults:
        print(f"judge: {fault}", file=sys.stderr)
    ok = not faults and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def main(argv=None) -> int:
    args = parse(argv)
    from harness import (LaunchTally, Probe, Runner, SpanLog, cleanup,
                         judge_in_flight, load_cell, load_reader, run_window,
                         workdir_for)

    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = workdir_for(cell.name)
    try:
        tally = LaunchTally()
        tally.install()
        runner = Runner(cell, args.seed, "cuda", workdir)
        runner.warm_up()
        readers, probes, spans, trace = {}, {}, None, None
        if args.trace:
            from tracing import DeviceTrace
            spans = SpanLog()
            for m in cell.per_layer:
                readers[m["name"]] = load_reader(m["name"])
                for spec in readers[m["name"]].PROBES:
                    probes.setdefault(spec, Probe(spec, spans))
            trace = DeviceTrace()
        torch.cuda.synchronize()
        launches0 = tally.snapshot()
        captures0 = graph_captures()
        setup_s = time.perf_counter() - T_PROCESS
        rec = run_window(runner, args.seconds, probes.values(), trace, spans)
        captures = graph_captures() - captures0
        launches1 = tally.snapshot()
        tally.remove()
        device = None
        summary = None
        t_read = time.perf_counter()
        if trace is not None:
            from tracing import summarize
            summary = summarize(trace, spans.spans)
            print(f"trace: stopped in {rec.trace_stop_s!r} s, "
                  f"{summary['n_ops']} device operations read in "
                  f"{time.perf_counter() - t_read!r} s", file=sys.stderr)
        device = device_info(summary)
        print(f"card {torch.cuda.get_device_name(0)}; sessions "
              f"{rec.sessions_done} finished, {rec.session + 1} begun; "
              f"frames {len(rec.frames)} out, {rec.late} late; setup_s "
              f"{setup_s!r}; graph captures in the window {captures}",
              file=sys.stderr)
        if args.trace:
            delta = ({k: v - launches0[0].get(k, 0)
                      for k, v in launches1[0].items()},
                     {k: v - launches0[1].get(k, 0)
                      for k, v in launches1[1].items()})
            ctx = Context(probes, rec, delta, captures, summary)
            metrics = {}
            for m in cell.per_layer:
                v = readers[m["name"]].read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            metrics = end_to_end(cell, rec, args.seconds, setup_s)
        # every figure is read: a window that finished no session has its
        # session in flight finalized for the judge now
        judge_in_flight(runner, rec)
        gc.collect()
        torch.cuda.empty_cache()
        t_judge = time.perf_counter()
        correct, checks = judge(cell, rec, runner, args.seed)
        print(f"judge: {time.perf_counter() - t_judge!r} s", file=sys.stderr)
    finally:
        cleanup(workdir)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: modules {bad} were loaded in this process",
              file=sys.stderr)
        return 3
    attempted = len(rec.frames)
    failed = sum(1 for f in rec.frames if f.pose is None)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if summary is not None:
        result["breakdown"] = breakdown(summary)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
