"""Lane traces: what a lane did, step by step, in a form that two runs of it
can be held against each other.

A trace records, for one run of a lane:

- ``attempts``: each monocular-initialization attempt that reached the
  RANSACs, as ``[reference frame, current frame, essential inliers,
  homography inliers]`` (``None`` where the homography was not drawn);
- ``landed``: the frame at which mono initialization made its two
  keyframes, and the newest keyframe's frame when the IMU solver's gyro
  stage and its gravity / scale stage finished;
- ``cycles``: each committed keyframe cycle, as ``[the keyframe's frame,
  keyframes, points, centre x, y, z]`` (the keyframe's camera centre after
  its cycle);
- ``loops``: each loop candidate that reached geometric verification, as
  ``[keyframe's frame, candidate's frame, pairs, Sim3 inliers, scale,
  verified]``;
- ``run`` and ``final``: tracked frames, keyframes, points and ATE after
  the run and after ``finalize()``, with the draw dtype.

``LaneTrace`` only wraps methods of the objects it is given, by name, so
it records the JAX package's system as well (``scripts/jax_lane_trace.py``
hands it that package's modules).  It reads nothing from a device while it
is installed: the Sim3 RANSAC's results are kept and read when it is
removed.  ``seconds`` is the host time its wrappers spent outside the
methods they wrap, so a timed run can be reported without it.
``first_parting`` names the first entry at which two traces differ in a
count or a frame, with the largest centre difference up to there.

    python -m snakeslam_tpu_torch.utils.lane_trace --lane mono_vi \\
        --device cpu --write

runs a lane of the port and stores its trace under ``port_cpu`` in
``data/reference_traces.json`` (``--write``; else it prints it).  Lanes:
``mono_vi`` (``vi_problems.build_lane``, window 16, two-stage, float64
draws as the JAX reference runs with x64), ``mono_vi_small`` (its small
configuration, 80 frames, window 8, no ``finalize``) and ``loop``
(``build_loop_lane``, window 64, float32 draws).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np

TRACE_FILE = Path(__file__).resolve().parent.parent / "data" / \
    "reference_traces.json"
LOOP_FRAMES, LOOP_WINDOW = 400, 64
SMALL_FRAMES = 80


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _centre(T) -> list[float]:
    T = np.asarray(T, dtype=np.float64)
    return [float(v) for v in -T[:3, :3].T @ T[:3, 3]]


class LaneTrace:
    """Records a trace of ``system``'s run while installed (a context
    manager).  ``mono_init`` and ``loop_closing`` are the modules whose
    ``essential_ransac``, ``homography_ransac`` and ``sim3_ransac`` the
    system's initializer and loop closer call."""

    def __init__(self, system, mono_init=None, loop_closing=None):
        self.system = system
        self.modules = (mono_init, loop_closing)
        self.trace = dict(attempts=[], landed=dict(mono_init=None, gyro=None,
                                                   gravity=None),
                          cycles=[], loops=[])
        self._stack = None
        self._sim3 = []                 # (loop entry, mask, n, scale)
        self._outer_s = self._inner_s = 0.0

    @property
    def seconds(self) -> float:
        """Host seconds spent in the recorder's own code while installed."""
        return self._outer_s - self._inner_s

    def _wrap(self, owner, name, make):
        inner = getattr(owner, name)
        if name in vars(owner):         # a module's function, or wrapped
            self._stack.callback(setattr, owner, name, inner)
        else:                           # a method found on the class
            self._stack.callback(delattr, owner, name)

        def timed_inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                self._inner_s += time.perf_counter() - t0

        made = make(timed_inner)

        def outer(*a, **k):
            t0 = time.perf_counter()
            try:
                return made(*a, **k)
            finally:
                self._outer_s += time.perf_counter() - t0
        setattr(owner, name, outer)

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        sysm, tr = self.system, self.trace
        smap = sysm.map
        init = getattr(sysm.tracker, "mono_initializer", None)
        mono_init, loop_closing = self.modules
        current = {}

        def process_frame(inner):
            def f(frame):
                out = inner(frame)
                if tr["landed"]["mono_init"] is None and \
                        smap.n_keyframes >= 2:
                    tr["landed"]["mono_init"] = int(frame.frame_id)
                return out
            return f
        self._wrap(sysm, "process_frame", process_frame)

        if init is not None and mono_init is not None:
            def try_initialize(inner):
                def f(tracker, frame):
                    current["frame"] = int(frame.frame_id)
                    return inner(tracker, frame)
                return f

            def essential(inner):
                def f(*a, **k):
                    out = inner(*a, **k)
                    tr["attempts"].append([
                        int(init.ref_frame.frame_id), current["frame"],
                        int(_host(out[2])), None])
                    return out
                return f

            def homography(inner):
                def f(*a, **k):
                    out = inner(*a, **k)
                    tr["attempts"][-1][3] = int(_host(out[2]))
                    return out
                return f
            self._wrap(init, "try_initialize", try_initialize)
            self._wrap(mono_init, "essential_ransac", essential)
            self._wrap(mono_init, "homography_ransac", homography)

        sol = getattr(sysm, "imu_solver", None)
        if sol is not None:
            def update_map(inner):
                def f():
                    inner()
                    newest = int(smap.kf_frame_id[
                        smap.valid_keyframes()].max())
                    for stage, done in (("gyro", sol.gyro_initialized),
                                        ("gravity", sol.gravity_initialized)):
                        if tr["landed"][stage] is None and done:
                            tr["landed"][stage] = newest
                return f
            self._wrap(sol, "update_map", update_map)

        def commit_deferred(inner):
            def f(token):
                out = inner(token)
                kf = int(token["kf"])
                if smap.kf_valid[kf]:
                    tr["cycles"].append(
                        [int(smap.kf_frame_id[kf]), int(smap.n_keyframes),
                         int(smap.n_points)] + _centre(smap.kf_pose[kf]))
                return out
            return f
        self._wrap(sysm.local_mapper, "commit_deferred", commit_deferred)

        lc = getattr(sysm, "loop_closing", None)
        if lc is not None and loop_closing is not None:
            def compute_sim3(inner):
                def f(kf, cand):
                    entry = [int(smap.kf_frame_id[kf]),
                             int(smap.kf_frame_id[cand]), None, None, None,
                             False]
                    current["loop"] = entry
                    n_sim3 = len(self._sim3)
                    out = inner(kf, cand)
                    entry[5] = out is not None
                    if len(self._sim3) > n_sim3:    # it reached the RANSAC
                        tr["loops"].append(entry)
                    return out
                return f

            def sim3(inner):
                def f(src, dst, mask, *a, **k):
                    out = inner(src, dst, mask, *a, **k)
                    self._sim3.append((current["loop"], mask, out[4],
                                       out[0]))
                    return out
                return f
            self._wrap(lc, "_compute_sim3", compute_sim3)
            self._wrap(loop_closing, "sim3_ransac", sim3)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        for entry, mask, n, scale in self._sim3:
            entry[2:5] = [int(_host(mask).sum()), int(_host(n)),
                          float(_host(scale))]
        self._sim3 = []

    def summary(self, key: str, with_scale: bool, draw: str):
        """Store tracked frames, keyframes, points and ATE under ``key``
        (``run`` after the run, ``final`` after ``finalize()``)."""
        s = self.system
        ate, _, _ = s.ate_against_gt(with_scale=with_scale)
        self.trace[key] = dict(tracked=len(s.tracker.trajectory),
                               keyframes=int(s.map.n_keyframes),
                               points=int(s.map.n_points), ate_m=float(ate),
                               draw=draw)


def _first_diff(xs, ys, same, frame):
    """(frame, index, x, y) of the first pair that is not ``same``, or of
    the first entry one list has beyond the other; None if none."""
    for i, (x, y) in enumerate(zip(xs, ys)):
        if not same(x, y):
            return frame(x, y), i, x, y
    if len(xs) != len(ys):
        i = min(len(xs), len(ys))
        extra = (xs if len(xs) > len(ys) else ys)[i]
        return frame(extra, extra), i, xs[i:i + 1], ys[i:i + 1]
    return None


def first_parting(a: dict, b: dict) -> dict:
    """Where traces ``a`` and ``b`` first differ in a count or a frame:
    the earliest, by frame, of the first differing attempt, landing,
    keyframe cycle and loop candidate (then the run's and ``finalize``'s
    counts); ``parting`` is None where they never differ.  Also the
    largest keyframe-centre difference over the cycles before it."""
    inf = float("inf")
    found = []
    d = _first_diff(a["attempts"], b["attempts"], lambda x, y: x == y,
                    lambda x, y: min(x[1], y[1]))
    if d:
        found.append((d[0], "attempt") + d[1:])
    for stage in ("mono_init", "gyro", "gravity"):
        x, y = a["landed"][stage], b["landed"][stage]
        if x != y:
            found.append((min(v if v is not None else inf for v in (x, y)),
                          "landed", stage, x, y))
    d = _first_diff(a["cycles"], b["cycles"], lambda x, y: x[:3] == y[:3],
                    lambda x, y: min(x[0], y[0]))
    if d:
        found.append((d[0], "cycle") + d[1:])
    d = _first_diff(a["loops"], b["loops"],
                    lambda x, y: x[:4] + x[5:] == y[:4] + y[5:],
                    lambda x, y: min(x[0], y[0]))
    if d:
        found.append((d[0], "loop") + d[1:])
    for key in ("run", "final"):
        fa = {k: a.get(key, {}).get(k) for k in ("tracked", "keyframes",
                                                 "points")}
        fb = {k: b.get(key, {}).get(k) for k in ("tracked", "keyframes",
                                                 "points")}
        if fa != fb:
            found.append((inf, key, None, fa, fb))
    first = min(found, key=lambda f: (f[0], len(found))) if found else None
    limit = first[0] if first else inf
    diffs = []
    for x, y in zip(a["cycles"], b["cycles"]):
        if x[:3] != y[:3] or max(x[0], y[0]) >= limit:
            break
        diffs.append(float(np.linalg.norm(np.subtract(x[3:6], y[3:6]))))
    return dict(
        parting=None if first is None else dict(
            frame=None if first[0] == inf else first[0], what=first[1],
            index=first[2], a=first[3], b=first[4]),
        cycles_compared=len(diffs),
        max_centre_diff_m=max(diffs) if diffs else 0.0)


def load(path: Path = TRACE_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def store(group: str, lane: str, trace: dict, path: Path = TRACE_FILE):
    """Write ``trace`` under ``[group][lane]`` of the trace file, keeping
    every other entry."""
    data = load(path) if path.exists() else {}
    data.setdefault(group, {})[lane] = trace
    with open(path, "w") as f:
        json.dump(data, f, indent=None, separators=(",", ":"))
        f.write("\n")


# ---------------------------------------------------------------------------
# the port's lanes
# ---------------------------------------------------------------------------

def loop_settings(world):
    """bench.py's ``_build_loop`` settings: stereo, 1024 feature slots,
    4096 pinned local-map slots, LBA slots 32 / 8192 / 8, th_depth 25,
    th_map 400."""
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings)
    from snakeslam_tpu_torch.system.settings import InputType, Settings

    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 1024
    s.local_map_slots = 4096
    s.pin_local_map_bucket = True
    s.lba_cam_slots, s.lba_point_slots, s.lba_obs_slots = 32, 8192, 8
    s.th_depth = 25.0
    s.th_map = 400
    apply_world_to_settings(world, s)
    return s


def build_loop_lane(device, n_frames: int = LOOP_FRAMES,
                    n_devices: int = 1):
    """(system, frames) of the loop lane on ``device``: bench.py's
    ``_build_loop(7, n_frames)`` (a 60000-point world, seed 7, an outward
    full orbit of radius 7 m at 200 fps, 0.3 px feature noise)."""
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        synthetic_frames)
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     loop_trajectory)

    world = SyntheticWorld(n_points=60000, seed=7)
    s = loop_settings(world)
    s.n_devices = n_devices
    frames = list(synthetic_frames(
        world, loop_trajectory(n_frames, radius=7.0, fps=200.0), s,
        noise_px=0.3))
    return SlamSystem(s, device), frames


def run_lane(lane: str, device) -> dict:
    """Run one of the port's lanes on ``device`` and return its trace."""
    from snakeslam_tpu_torch.core import prng
    from snakeslam_tpu_torch.loop import loop_closing
    from snakeslam_tpu_torch.tracking import mono_init
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils import vi_problems as VP

    if lane == "loop":
        system, frames = build_loop_lane(device)
        runner, x64, with_scale = (WindowedRunner(system, window=LOOP_WINDOW),
                                   False, False)
    elif lane == "mono_vi":
        system, frames = VP.build_lane(device)
        runner, x64, with_scale = (WindowedRunner(
            system, window=VP.WINDOW, two_stage=True), True, True)
    elif lane == "mono_vi_small":
        system, frames = VP.build_lane(
            device, **dict(VP.SMALL, n_frames=SMALL_FRAMES))
        runner, x64, with_scale = (WindowedRunner(
            system, window=VP.SMALL_WINDOW), True, True)
    else:
        raise ValueError(f"unknown lane {lane!r}")
    draw = "float64" if x64 else "float32"
    with prng.x64(x64), LaneTrace(system, mono_init, loop_closing) as rec:
        runner.run(frames)
        rec.summary("run", with_scale, draw)
        if lane != "mono_vi_small":
            system.finalize()
            rec.summary("final", with_scale, draw)
    rec.trace["lane"] = dict(name=lane, frames=len(frames), draw=draw)
    return rec.trace


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", required=True,
                    choices=["mono_vi", "mono_vi_small", "loop"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    trace = run_lane(args.lane, args.device)
    if args.write:
        store(f"port_{torch.device(args.device).type}", args.lane, trace)
    print(json.dumps(trace["run"]), json.dumps(trace.get("final")),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
