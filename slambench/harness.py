"""One run of one cell: set-up, the measured window of back-to-back
sessions, the readings, the judge.

A cell names a configuration (``configs/<name>.json``) and its traffic
(``workloads/<cell>.json``); each per-layer metric is a reader of its own
(``metrics/<metric>.py``).  This module knows three entries, named by
the configuration's ``entry`` (``ENTRIES``):

* ``windowed``: ``WindowedRunner(SlamSystem(settings, device), window)
  .run(frames)`` then ``system.finalize()``, on feature-level frames;
* ``per_frame_input``: the CLI's own path, ``SlamSystem.run(iter(Input(
  settings, dataset_root, device)))``, over a sequence written into a
  dataset's layout, the ``Input`` built before the system as the CLI
  builds them (a dataset's own calibration reaches the settings first);
* ``per_frame``: ``SlamSystem.run(frames)`` on feature-level frames, the
  per-frame tracker with no reader and no ORB.

The traffic file names its generator, ``traffic/<generator>.py``, which
makes the cell's sequences from seeds drawn from the run's seed (see
``traffic/sequence.py``).  The judge's numbers are the traffic file's
``limits``; one that is not built into ``reference/judge.py`` is a module
of its own, ``reference/numbers/<name>.py``, whose recording hooks the
``Recorder`` calls while the window runs.

Each session gets a new ``SlamSystem`` on the next of the cell's
sequences.  A frame counts when its pose is out on the host before the
window closes (the windowed runner's ``_consume`` returned, or the
system's frame listener ran); the session in flight at the close is
dropped, unless the window finished no session: then ``judge_in_flight``
finalizes a per-frame entry's after the window, for the judge alone.  What the judge needs
(each tracked frame's pose, matches, the map points it was tracked
against and the motion prior it was refined with; each finished session's
map after ``finalize``, with its IMU constraints; each session's camera)
is recorded by wrappers around the program's methods.
"""

from __future__ import annotations

import configparser
import gc
import importlib.util
import itertools
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from probes import LaunchTally, Probe, SpanLog, resolve
from reference.judge import file_numbers
from traffic.frames import frame_data
from traffic.sequence import Sequence

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
ENTRIES = ("windowed", "per_frame_input", "per_frame")


class WindowClosed(Exception):
    """Raised from inside a session when the window has closed."""


# ---------------------------------------------------------------------------
# the manifest and the files a cell is made of
# ---------------------------------------------------------------------------

def load_manifest(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    entry: dict                   # the cell's line of BENCHMARK.json
    config: dict                  # configs/<config>.json
    traffic: dict                 # workloads/<cell>.json
    end_to_end: list              # its end-to-end metrics' entries
    per_layer: list               # its per-layer metrics' entries


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, manifest: dict | None = None,
              root: Path = REPO) -> Cell:
    m = manifest or load_manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg = next(c for c in m["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    e2e = [x for x in m["end_to_end"]
           if "workloads" not in x or name in x["workloads"]]
    reported = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"] if _reports(x, name, reported)]
    return Cell(name, entry, config, traffic, e2e, layer)


def _load(path: Path, name: str):
    """The module of ``path``, as ``name`` in ``sys.modules`` (a dataclass
    defined in it looks its module up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """The reader module of a per-layer metric: ``metrics/<metric>.py``,
    with ``PROBES`` (method specs to time) and ``read(ctx)``."""
    return _load(HERE / "metrics" / f"{metric}.py",
                 "slambench_metric_" + metric.replace(".", "_"))


def load_generator(name: str):
    """The traffic generator ``traffic/<name>.py``, with
    ``sequences(cell, seeds, workdir)``."""
    path = HERE / "traffic" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no generator {name!r}: {path} is missing")
    return _load(path, "slambench_traffic_" + name.replace(".", "_"))


# ---------------------------------------------------------------------------
# settings and sequences
# ---------------------------------------------------------------------------

def _ini_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def make_settings(config: dict, workdir: Path, dataset_dir: str = ""):
    """The program's ``Settings`` of ``config``: its INI written into
    ``workdir`` (``Settings.from_ini`` writes missing keys back into the
    file it reads), then the keys that are not INI keys."""
    from snakeslam_tpu_torch.system.settings import Settings

    cp = configparser.ConfigParser()
    for section, keys in config["ini"].items():
        cp.add_section(section)
        for k, v in keys.items():
            cp.set(section, k, _ini_value(v))
    cp.set("Dataset", "dataset_dir", dataset_dir)
    path = workdir / f"{config['name']}.ini"
    with open(path, "w") as f:
        cp.write(f)
    s = Settings.from_ini(path)
    for k, v in config.get("settings", {}).items():
        setattr(s, k, v)
    return s


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` 32-bit seeds drawn from the run's seed."""
    return [int(s.generate_state(1)[0])
            for s in np.random.SeedSequence(seed).spawn(n)]


def make_sequences(cell: Cell, seed: int, workdir: Path):
    """(the session sequences, the warm-up sequence) of a cell from its
    seed, by the generator its traffic names."""
    t = cell.traffic
    seeds = sub_seeds(seed, t["sequences"] + 1)
    return load_generator(t["generator"]).sequences(cell, seeds, workdir)


# ---------------------------------------------------------------------------
# what the judge needs, recorded during the window
# ---------------------------------------------------------------------------

@dataclass
class FrameRec:
    session: int
    frame_id: int
    t_out: float                  # perf_counter when its pose was out
    pose: np.ndarray | None       # world -> camera, as tracked
    uv: np.ndarray | None = None
    right: np.ndarray | None = None
    octave: np.ndarray | None = None
    points: np.ndarray | None = None   # the matched points it was tracked
    kind: str = "track"                #   against: "track", "window",
                                       #   "init" or "lost"
    t_start: float | None = None  # per-frame path: the reader started
    features: tuple | None = None      # per-frame path: ORB's output
    depth: np.ndarray | None = None    # an init frame's feature depths
    source: tuple | None = None        # where ``points`` are read from
    prior: tuple | None = None         # per-frame path: (pose, rotation
                                       #   weight) of the motion prior it
                                       #   was refined with, where weighted
                                       #   (the gyro's)
    extra: dict = field(default_factory=dict)   # a judge number's
                                                #   ``keep_frame``, by name

    def resolve(self):
        """Fill ``points`` from the tensors the tracker read, once the
        window has closed (reading them earlier would wait on the
        device)."""
        if self.source is None:
            return
        kind, *args = self.source
        n = len(self.uv)
        pts = np.full((n, 3), np.nan)
        if kind == "window":
            position, assign = args
            m = assign >= 0
            pts[m] = position.cpu().double().numpy()[assign[m]]
        else:
            (position, fine_ids, coarse_pos, coarse_matched, matches,
             prior) = args
            self.prior = _read_prior(*prior)
            cm = coarse_matched.cpu().numpy()[:n]
            cp = coarse_pos.cpu().double().numpy()[:n]
            lm = position.cpu().double().numpy()
            m = matches >= 0
            coarse = m & cm
            fine = m & ~cm
            pts[coarse] = cp[coarse]
            pts[fine] = lm[np.searchsorted(fine_ids, matches[fine])]
        self.points = pts
        self.source = None


def _rotation_weight(w_rot, w_trans) -> float:
    """The weight of a motion prior's or a relative-pose constraint's
    rotation; the judge holds rotation terms alone, as the program weighs
    no translation there (tracking/tracker.py, imu/state_solver.py)."""
    if float(w_trans) != 0.0:
        raise ValueError(f"a translation weight {float(w_trans)!r}: the "
                         f"judge's IMU terms are rotations alone")
    return float(w_rot)


def _read_prior(pose, w_rot, w_trans):
    """(pose (4, 4), rotation weight) of a pose refine's motion prior, from
    the tensors it was given; None where it has no weight."""
    w = _rotation_weight(w_rot, w_trans)
    if not w:
        return None
    return pose.cpu().double().numpy(), w


@dataclass
class MapRec:
    session: int
    kf_ids: np.ndarray            # keyframe slots, in frame order
    kf_frame_id: np.ndarray       # their frames' ids
    kf_pose: np.ndarray
    kf_uv: np.ndarray             # (K, N, 2) the keyframes' features
    kf_right: np.ndarray
    kf_octave: np.ndarray
    pt_ids: np.ndarray
    pt_pos: np.ndarray
    pt_obs_kf: np.ndarray         # (P, MAX_OBS) observing keyframe slots
    pt_obs_feat: np.ndarray
    loops: int
    rpc: list = field(default_factory=list)     # the IMU solver's relative-
                                                #   pose constraints over the
                                                #   keyframes: (row i, row j,
                                                #   T (4, 4), rotation weight)
    extra: dict = field(default_factory=dict)   # a judge number's
                                                #   ``keep_map``, by name


class Recorder:
    """Stamps frames and keeps the judge's inputs; installed on the
    program's classes for the window.  ``number_modules`` maps the judge
    numbers that are modules of their own to them: each one's
    ``keep_frame(frame)`` runs on every frame recorded, its
    ``keep_map(system)`` after each ``finalize``."""

    def __init__(self, deadline: float, spans: SpanLog | None = None,
                 number_modules: dict | None = None):
        self.deadline = deadline
        self.spans = spans
        mods = number_modules or {}
        self._keep_frame = {n: m.keep_frame for n, m in mods.items()
                            if hasattr(m, "keep_frame")}
        self._keep_map = {n: m.keep_map for n, m in mods.items()
                          if hasattr(m, "keep_map")}
        self.reads = 0                # per-frame path: frames read
        self.read_s = 0.0             #   and the reader's seconds
        self.session = -1
        self.cameras: dict = {}       # session -> (fx, fy, cx, cy, bf) its
                                      #   system was built with
        self.frames: list[FrameRec] = []
        self.late = 0                 # poses out after the close
        self.maps: list[MapRec] = []
        self.sessions_done = 0
        self.dispatched = 0           # window frames dispatched
        self.session_dispatched: dict = {}   # per session: dispatched
        self.session_consumed: dict = {}     #   and consumed frames
        self._snap: dict = {}         # id(lm_ids) -> (lm_ids, device positions)
        self._tracked: dict = {}      # id(frame) -> (pose, points source)
        self._fine_in = None          # the last fine step's inputs
        self._undo = []

    # -- installation ------------------------------------------------------

    def _wrap(self, spec, make):
        owner, name = resolve(spec)
        inner = getattr(owner, name)
        setattr(owner, name, make(inner))
        self._undo.append((owner, name, inner))

    def install(self):
        rec = self

        def local_map(inner):
            def f(runner, *a, **k):
                out = inner(runner, *a, **k)
                ids = out[1]
                if ids is not None and id(ids) not in rec._snap:
                    rec._snap[id(ids)] = (ids, out[0].position)
                return out
            return f

        def dispatch(inner):
            def f(runner, frames, start, W, *a, **k):
                item, carry = inner(runner, frames, start, W, *a, **k)
                n = len(item.batch)
                rec.dispatched += n
                rec.session_dispatched[rec.session] = (
                    rec.session_dispatched.get(rec.session, 0) + n)
                return item, carry
            return f

        def consume(inner):
            def f(runner, item, outs, assign, vis, fnd):
                before = [fr.pose_cw is None for fr in item.batch]
                r = inner(runner, item, outs, assign, vis, fnd)
                t = time.perf_counter()
                _, position = rec._snap[id(item.lm_ids)]
                n = sum(1 for w, fr in enumerate(item.batch)
                        if before[w] and fr.pose_cw is not None)
                rec.session_consumed[rec.session] = (
                    rec.session_consumed.get(rec.session, 0) + n)
                for w, fr in enumerate(item.batch):
                    if not before[w] or fr.pose_cw is None:
                        continue
                    if t > rec.deadline:
                        rec.late += 1
                        continue
                    a = assign[w, :fr.n].astype(np.int64)
                    rec.frames.append(FrameRec(
                        rec.session, fr.frame_id, t, fr.pose_cw.copy(),
                        fr.uv, fr.right, fr.octave, kind="window",
                        source=("window", position, a),
                        extra=rec.frame_extra(fr)))
                if t > rec.deadline:
                    raise WindowClosed
                return r
            return f

        def fine_step(inner):
            def f(lm, feats, T_coarse, coarse_pos, coarse_matched, cam, bf,
                  bounds, scales, log_sf, th, prior_T, w_rot, w_trans, *a,
                  **k):
                rec._fine_in = (lm.position, coarse_pos, coarse_matched,
                                (prior_T, w_rot, w_trans))
                return inner(lm, feats, T_coarse, coarse_pos, coarse_matched,
                             cam, bf, bounds, scales, log_sf, th, prior_T,
                             w_rot, w_trans, *a, **k)
            return f

        def track(inner):
            def f(tracker, frame, *a, **k):
                rec._fine_in = None
                ok = inner(tracker, frame, *a, **k)
                if ok:
                    position, coarse_pos, coarse_matched, prior = rec._fine_in
                    rec._tracked[id(frame)] = (
                        frame.pose_cw.copy(),
                        ("track", position, tracker._fine_cache[1],
                         coarse_pos, coarse_matched, frame.matches.copy(),
                         prior))
                return ok
            return f

        def initialize(inner):
            def f(tracker, frame, *a, **k):
                ok = inner(tracker, frame, *a, **k)
                if ok and frame.matches is not None:
                    m = frame.matches
                    pts = np.full((frame.n, 3), np.nan)
                    pts[m >= 0] = tracker.map.pt_pos[m[m >= 0]]
                    rec._tracked[id(frame)] = ("init", pts)
                return ok
            return f

        def finalize(inner):
            def f(system, *a, **k):
                out = inner(system, *a, **k)
                rec.keep_map(system)
                return out
            return f

        W = "snakeslam_tpu_torch.tracking.windowed:WindowedRunner"
        T = "snakeslam_tpu_torch.tracking.tracker:Tracker"
        self._wrap(W + "._local_map", local_map)
        self._wrap(W + "._dispatch", dispatch)
        self._wrap(W + "._consume", consume)
        self._wrap(T + "._track", track)
        self._wrap("snakeslam_tpu_torch.tracking.tracker:fine_step",
                   fine_step)
        self._wrap(T + "._initialize", initialize)
        self._wrap("snakeslam_tpu_torch.system.slam:SlamSystem.finalize",
                   finalize)

    def remove(self):
        for owner, name, inner in reversed(self._undo):
            setattr(owner, name, inner)
        self._undo = []

    # -- per session ---------------------------------------------------------

    def new_session(self, system):
        self.session += 1
        self._snap.clear()
        self._tracked.clear()
        s = system.s
        self.cameras[self.session] = tuple(float(v) for v in (
            s.fx, s.fy, s.cx, s.cy, s.bf))
        system.frame_listeners.append(self.on_frame)

    def on_frame(self, frame):
        """The system's frame listener: the per-frame path's pose is out."""
        t = time.perf_counter()
        tr = self._tracked.pop(id(frame), None)
        start = getattr(frame, "_bench_read_start", None)
        if t > self.deadline:
            self.late += 1
            raise WindowClosed
        feats = getattr(frame, "_bench_features", None)
        if frame.pose_cw is None or tr is None:
            # lost, or posed without the tracker's refine (relocalized):
            # counted, not judged
            lost = frame.pose_cw is None
            self.frames.append(FrameRec(
                self.session, frame.frame_id, t,
                None if lost else frame.pose_cw.copy(),
                kind="lost" if lost else "untracked", t_start=start,
                features=feats, extra=self.frame_extra(frame)))
            return
        if isinstance(tr[0], str):
            self.frames.append(FrameRec(
                self.session, frame.frame_id, t, frame.pose_cw.copy(),
                frame.uv, frame.right, frame.octave, tr[1], kind="init",
                t_start=start, features=feats, depth=frame.depth,
                extra=self.frame_extra(frame)))
            return
        self.frames.append(FrameRec(
            self.session, frame.frame_id, t, tr[0], frame.uv, frame.right,
            frame.octave, kind="track", t_start=start, features=feats,
            source=tr[1], extra=self.frame_extra(frame)))

    def frame_extra(self, frame) -> dict:
        """What the judge numbers' ``keep_frame`` hooks keep of ``frame``."""
        return {n: f(frame) for n, f in self._keep_frame.items()}

    def keep_map(self, system):
        smap = system.map
        kfs = smap.valid_keyframes()
        kfs = kfs[np.argsort(smap.kf_frame_id[kfs])]
        pts = smap.valid_points()
        # the constraints the global BA packs over these keyframes
        # (optim/gba.py, optim/lba.py's pack_rpc)
        sol = getattr(system, "imu_solver", None)
        row = {int(k): i for i, k in enumerate(kfs)}
        rpc = [(row[i], row[j], np.array(T, np.float64),
                _rotation_weight(w_r, w_t))
               for i, j, T, w_t, w_r in
               (sol.rpc_for_window(list(row)) if sol is not None else None)
               or ()]
        self.maps.append(MapRec(
            self.session, kfs, smap.kf_frame_id[kfs].astype(np.int64),
            smap.kf_pose[kfs].copy(),
            smap.kf_feat_uv[kfs].copy(), smap.kf_feat_right[kfs].copy(),
            smap.kf_feat_octave[kfs].copy(), pts, smap.pt_pos[pts].copy(),
            smap.pt_obs_kf[pts].copy(), smap.pt_obs_feat[pts].copy(),
            int(system.loop_closing.n_loops_closed), rpc,
            {n: f(system) for n, f in self._keep_map.items()}))


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

class InputFrames:
    """The CLI's frame iterator, stamped: the time the reader starts on a
    frame rides on the frame to the listener; the window's close stops
    the session before the next read."""

    def __init__(self, inp, rec=None, limit: int | None = None,
                 keep_features: set | None = None):
        self.inp = inp
        self.rec = rec
        self.limit = limit
        self.keep = keep_features or set()

    def __iter__(self):
        it = iter(self.inp)
        for k in itertools.count():
            if self.limit is not None and k >= self.limit:
                return
            rec = self.rec
            if rec is not None and time.perf_counter() > rec.deadline:
                raise WindowClosed
            t0 = time.perf_counter_ns()
            try:
                frame = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter_ns()
            if rec is not None:
                rec.reads += 1
                rec.read_s += (t1 - t0) * 1e-9
                if rec.spans is not None:
                    rec.spans.add("Input.read", t0, t1)
            frame._bench_read_start = t0 * 1e-9
            if frame.frame_id in self.keep:
                frame._bench_features = (frame.uv.copy(), frame.octave.copy(),
                                         frame.angle.copy(),
                                         frame.descriptors.copy())
            yield frame


class Runner:
    """Builds sessions of one cell on ``device``.  ``numbers`` are the
    judge numbers recorded for (default: the traffic's ``limits``)."""

    def __init__(self, cell: Cell, seed: int, device, workdir: Path,
                 numbers: list | None = None):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.workdir = workdir
        self.entry = cell.config["entry"]
        if self.entry not in ENTRIES:
            raise ValueError(f"entry {self.entry!r} is none of {ENTRIES}")
        self.numbers = list(cell.traffic.get("limits", {})
                            if numbers is None else numbers)
        self.number_modules = file_numbers(self.numbers)
        self.seqs, self.warm = make_sequences(cell, seed, workdir)
        self.orb_frames = self._orb_sample()
        self.in_flight = None     # the system of the per-frame session
                                  #   running

    @property
    def truth(self) -> list | None:
        """Per sequence the true camera centres, where the generator
        gives them."""
        if all(q.truth is not None for q in self.seqs):
            return [q.truth for q in self.seqs]
        return None

    def _orb_sample(self) -> set:
        n = int(self.cell.traffic.get("orb_check_frames", 0))
        if not n:
            return set()
        rng = np.random.default_rng(sub_seeds(self.seed, 1)[0] ^ 0x5EED)
        return set(int(i) for i in rng.choice(self.seqs[0].frames, n,
                                              replace=False))

    def settings(self, seq: Sequence):
        return make_settings(self.cell.config, self.workdir,
                             str(seq.root) if seq.root else "")

    def _system(self, seq: Sequence):
        """The session's system on ``seq``, built as the CLI builds it, and
        the per-frame entry's ``Input`` (None on feature-level frames),
        built first: a dataset's own calibration reaches the settings
        before the tracker, the BA and the IMU solver take their copies."""
        from snakeslam_tpu_torch.system.slam import SlamSystem
        s = self.settings(seq)
        inp = None
        if self.entry == "per_frame_input":
            from snakeslam_tpu_torch.frontend.input import Input
            inp = Input(s, dataset_root=str(seq.root), device=self.device)
        return SlamSystem(s, self.device), inp

    def _frames(self, seq: Sequence):
        from snakeslam_tpu_torch.map.slam_map import FrameData
        return [frame_data(r, FrameData) for r in seq.raw]

    def _windowed(self, system):
        from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
        return WindowedRunner(system, window=self.cell.traffic["window"])

    def warm_up(self):
        """A throw-away system over the warm-up frames, then its
        ``finalize``: every graph of the cell's tracking and keyframe-cycle
        shapes is captured, and the libraries the global BA and realign
        load are loaded (a process's first ``finalize`` reads them from
        disk).  The warm-up map is small: the global BA's and loop
        closing's graphs at the window's map sizes are still met first in
        the window, as a user's process meets them."""
        seq = self.warm
        system, inp = self._system(seq)
        if self.entry == "windowed":
            self._windowed(system).run(self._frames(seq))
        else:
            frames = inp if inp is not None else self._frames(seq)
            for frame in InputFrames(frames, limit=seq.frames):
                system.process_frame(frame)
        system.finalize()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del system, inp
        gc.collect()

    def session(self, k: int, rec: Recorder):
        """Session ``k`` on sequence ``k mod n``: build, run, finalize.  A
        per-frame session's system stays in ``in_flight`` until it has
        finished."""
        seq = self.seqs[k % len(self.seqs)]
        system, inp = self._system(seq)
        rec.new_session(system)
        if self.entry == "windowed":
            self._windowed(system).run(self._frames(seq))
            system.finalize()
        else:
            self.in_flight = system
            keep = self.orb_frames if k < len(self.seqs) else set()
            frames = inp if inp is not None else self._frames(seq)
            system.run(InputFrames(frames, rec, keep_features=keep))
        self.in_flight = None
        rec.sessions_done += 1


def run_window(runner: Runner, seconds: float, probes=(), trace=None,
               spans: SpanLog | None = None):
    """Sessions back to back for ``seconds``; returns the recorder and the
    window's host seconds."""
    for p in probes:
        p.install()
    if trace is not None:
        trace.start()
    t_open = time.perf_counter()
    rec = Recorder(t_open + seconds, spans, runner.number_modules)
    rec.install()
    try:
        for k in itertools.count():
            if time.perf_counter() > rec.deadline:
                break
            t0 = time.perf_counter_ns()
            try:
                runner.session(k, rec)
            except WindowClosed:
                break
            finally:
                if spans is not None:
                    spans.add("session", t0, time.perf_counter_ns())
    finally:
        rec.remove()
        for p in probes:
            p.remove()
    if rec.sessions_done:
        runner.in_flight = None
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    if trace is not None:
        t0 = time.perf_counter()
        trace.stop()
        rec.trace_stop_s = time.perf_counter() - t0
    for f in rec.frames:
        f.resolve()
    rec._snap.clear()
    return rec


def judge_in_flight(runner: Runner, rec: Recorder) -> bool:
    """Where the window finished no session: the per-frame session in
    flight at its close finalized now, after the window and its readings,
    and its map recorded as a finished session's, so that the judge has a
    map to read.  Its frames stay as the window recorded them; it closed
    between two frames, where ``SlamSystem.run`` finalizes too.  (The
    windowed entry's session closes inside a window of frames, at no such
    boundary, and is not judged.)  Returns whether it did so."""
    system, runner.in_flight = runner.in_flight, None
    if rec.sessions_done:
        return False
    if system is None:
        print("judge: the window finished no session, and no per-frame "
              "session is in flight to finalize: no map judged",
              file=sys.stderr)
        return False
    t0 = time.perf_counter()
    system.finalize()
    rec.keep_map(system)
    print(f"judge: the window finished no session; the map judged is that "
          f"of session {rec.session}, in flight at the close, finalized "
          f"after the window in {time.perf_counter() - t0!r} s",
          file=sys.stderr)
    return True


def workdir_for(cell: str) -> Path:
    """A scratch directory for the run's INI and rendered frames under the
    run's ``TMPDIR``; removed by ``cleanup``."""
    return Path(tempfile.mkdtemp(prefix=f"slambench-{cell}-"))


def cleanup(path: Path):
    shutil.rmtree(path, ignore_errors=True)
