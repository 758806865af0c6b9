"""What decides ``correct``: the program's answers against the reference's.

Every number is a worst case (a maximum) over the answers a run produced
in its window, each held against the reference's own answer worked out in
float64 from the benchmark's inputs and from the program's discrete
choices, which the reference follows (see PERF.md, "How correct is
decided"):

* ``frame_excess_chi2``: each tracked frame's pose against the robust
  pose optimum of that frame's observations of the map points it was
  matched to, at the positions the tracker read, and of the motion prior
  it was refined with where that has a weight (the gyro rotation prior
  with an IMU on): the cost of the frame's pose above the optimum's (a
  distance in mm would be ruled by the frames held by a few dozen
  matches, whose optimum is mm wide);
* ``init_gap_mm``: the points a session's first frame creates against
  the unprojection of its features at their depths (the map's origin);
* ``kf_gap_mm``: after ``finalize``, each keyframe the global BA moves
  against the pose optimum of its observations of the final points (the
  observations that BA holds: a point's first 16 live ones) and, with an
  IMU solver, of its relative-rotation constraints to the keyframes next
  to it, held at their final poses (the constraints that BA holds);
* ``point_excess_chi2``: after ``finalize``, each point against the
  optimum of its position under the final keyframe poses, over the same
  observations, by the robust cost of the point above the optimum's;
* ``frame_excess_chi2_mean``: the mean of the frames' excess costs: a
  small error in every pose (half of each frame's observations left out
  of its solve) that no single frame shows beyond the weakly held ones'
  spread;
* ``orb_mismatch_pct``: ORB's features of frames drawn from the seed
  against the reference ORB on the same image file;
* ``kf_ate_mm``: after ``finalize``, each finished session's keyframe
  positions against the generator's ground truth, after the similarity
  that best aligns them (the absolute trajectory error): the one number
  that holds the map to the world rather than to itself, where drift, a
  missed loop or a wrong correction that the global BA settles into a
  consistent map can show;
* ``loops_missed``: finished sessions that closed fewer loops than the
  traffic's revisits make (``loops_per_session``), a count the traffic
  states.

A cell is judged by the numbers its traffic file's ``limits`` list, and
only those are computed, with what they derive from: the frames' excess
costs for their mean, and one pass over the maps for ``kf_gap_mm``,
``point_excess_chi2`` and ``kf_ate_mm``.  A listed number that is not
built in is a module of its own, ``reference/numbers/<name>.py`` (see
``load_number``).  Every number reads tracked frames, finished sessions'
maps, or other things (``FRAME_NUMBERS``, ``MAP_NUMBERS``, a module's
``READS``), and a cell's limits list at least one of each of the first
two (``limits_faults``).

The camera of a session's frames and map is the one its system was built
with (``Recorder.cameras``): a dataset's own calibration, where it has
one, else the configuration's.  ``imu=False`` reads the problems without
their IMU terms, the visual problems alone.

``measure`` gives each number's per-item readings (a frame, a keyframe, a
point, a session's map); ``readings`` reduces them to what a run is
judged by.

``dtype=torch.bfloat16`` computes the control: the reference put in the
program's place in the precision below float32, and judged the same way.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

from reference import geometry as G

# in the order a run prints them
BUILT_IN = ("frame_excess_chi2", "init_gap_mm", "kf_gap_mm",
            "point_excess_chi2", "kf_ate_mm", "orb_mismatch_pct",
            "frame_excess_chi2_mean", "loops_missed")
FRAME_NUMBERS = ("frame_excess_chi2", "frame_excess_chi2_mean")
MAP_NUMBERS = ("kf_gap_mm", "point_excess_chi2", "kf_ate_mm")
READS = ("frames", "maps", "other")   # what a number reads
NUMBERS = Path(__file__).resolve().parent / "numbers"
GBA_OBS = 16          # observations of a point the global BA packs
BLOCK = 256           # frames per solve
MAX_FRAMES = 1024     # tracked frames judged a run: all, or a sample
MAX_MAPS = 4          # finished sessions' maps judged a run: all, or a sample


def sample(items, k: int, seed: int) -> list:
    """All of ``items``, or ``k`` of them drawn from ``seed``, in order."""
    if len(items) <= k:
        return list(items)
    idx = np.sort(np.random.default_rng(seed).choice(len(items), k,
                                                     replace=False))
    return [items[i] for i in idx]


def _weights(octave, scale_factor):
    return G.inv_scale_sq(torch.as_tensor(np.asarray(octave, np.int64)),
                          scale_factor, torch.float64)


def _pad(rows, n, fill):
    out = np.full((len(rows), n) + rows[0].shape[1:], fill,
                  dtype=rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _rotation_block(terms):
    """(A, B, w) tensors of a block of pose problems' rotation terms, each
    problem's a list of (A (3, 3), B (3, 3), w), padded with weightless
    ones; None where no problem has one."""
    k = max(len(t) for t in terms)
    if not k:
        return None
    A = np.tile(np.eye(3), (len(terms), k, 1, 1))
    B = A.copy()
    w = np.zeros((len(terms), k))
    for i, ts in enumerate(terms):
        for j, (a, b, wt) in enumerate(ts):
            A[i, j], B[i, j], w[i, j] = a, b, wt
    return tuple(torch.from_numpy(x) for x in (A, B, w))


def _pose_gaps(T_prog, pts, uv, right, octv, cam, bf, sf, dtype,
               device="cpu", excess: bool = False, rotation=None):
    """Camera-centre gaps (mm) of B pose problems against their optima or,
    with ``excess``, the cost of the judged pose above the optimum's
    (chi2 units: squared pixels over the octave's scale); with a lower
    ``dtype`` the answer judged is the reference's own in that precision,
    started where the program started it.  ``rotation`` holds per problem
    its rotation terms, a list of (A, B, w): residual log(A R B) of the
    pose's rotation R, with weight w."""
    out, judged_c = [], []
    for s in range(0, len(T_prog), BLOCK):
        sl = slice(s, s + BLOCK)
        rel = None if rotation is None else _rotation_block(rotation[sl])
        n = max(len(p) for p in pts[sl])
        P = torch.from_numpy(_pad(pts[sl], n, np.nan))
        valid = ~torch.isnan(P[..., 0])
        P = torch.nan_to_num(P)
        U = torch.from_numpy(_pad([u.astype(np.float64) for u in uv[sl]],
                                  n, 0.0))
        Rr = torch.from_numpy(_pad([r.astype(np.float64) for r in right[sl]],
                                   n, -1.0))
        W2 = _weights(_pad([o.astype(np.int64) for o in octv[sl]], n, 0), sf)
        T0 = torch.from_numpy(np.stack(T_prog[sl]).astype(np.float64)).to(
            device)
        ref = G.solve_poses(T0, P, U, Rr, W2, valid, cam, bf, torch.float64,
                            rotation=rel)
        judged = T0
        if dtype != torch.float64:
            judged = G.solve_poses(T0, P, U, Rr, W2, valid, cam, bf, dtype,
                                   rotation=rel)
        judged = judged.double()
        if excess:
            d = (G.pose_costs(judged, P, U, Rr, W2, valid, cam, bf, rel)
                 - G.pose_costs(ref, P, U, Rr, W2, valid, cam, bf, rel))
        else:
            d = G.gap_mm(G.centres(judged), G.centres(ref))
        out.append(d.cpu().numpy())
        judged_c.append(G.centres(judged).cpu())
    if not out:
        return np.zeros(0), torch.zeros(0, 3, dtype=torch.float64)
    return np.concatenate(out), torch.cat(judged_c)


def _by_camera(items, cameras) -> dict:
    """{camera: indices of ``items``} by the camera of each one's
    session."""
    groups: dict = {}
    for i, x in enumerate(items):
        groups.setdefault(cameras[x.session], []).append(i)
    return groups


def frame_excess(frames, cameras, sf, dtype=torch.float64, device="cpu",
                 seed: int = 0, imu: bool = True) -> np.ndarray:
    """Per tracked frame, the cost of its pose above the optimum of its own
    matches and of its motion prior, where it has one (with ``imu``): a
    weakly held pose (a few dozen matches) may lie mm from that optimum at
    no cost, a well held one may not.  ``cameras`` maps a session to its
    (fx, fy, cx, cy, bf)."""
    fr = sample([f for f in frames if f.kind in ("track", "window")],
                MAX_FRAMES, seed)
    out = np.zeros(len(fr))
    for camera, idx in _by_camera(fr, cameras).items():
        sel = [fr[i] for i in idx]
        rotation = None
        if imu and any(f.prior is not None for f in sel):
            # the rotation of the prior's residual log(T P^-1)
            # (tracking/tracker.py's fine step, ops/pose_solver.py's
            # robust_pose_refine)
            rotation = [[] if f.prior is None else
                        [(np.eye(3), f.prior[0][:3, :3].T, f.prior[1])]
                        for f in sel]
        out[idx] = _pose_gaps(
            [f.pose for f in sel], [f.points for f in sel],
            [f.uv for f in sel], [f.right for f in sel],
            [f.octave for f in sel], camera[:4], camera[4], sf, dtype,
            device, excess=True, rotation=rotation)[0]
    return out


def init_gaps(frames, cameras, dtype=torch.float64) -> np.ndarray:
    out = []
    for f in frames:
        if f.kind != "init":
            continue
        cam = cameras[f.session][:4]
        m = ~np.isnan(f.points[:, 0])
        uv = torch.from_numpy(f.uv[m].astype(np.float64)).to(dtype)
        z = torch.from_numpy(f.depth[m].astype(np.float64)).to(dtype)
        c = tuple(torch.tensor(x, dtype=dtype) for x in cam)
        ref = G.unproject(uv, z, c)
        prog = torch.from_numpy(f.points[m])
        if dtype == torch.float64:
            out.append(G.gap_mm(prog, ref).numpy())
        else:
            exact = G.unproject(uv.double(), z.double(),
                                tuple(float(x) for x in cam))
            out.append(G.gap_mm(ref.double(), exact).numpy())
    return np.concatenate(out) if out else np.zeros(0)


def _packed_obs(m):
    """Per point the global BA's observations: the first ``GBA_OBS``
    observation slots whose keyframe is live, as (keyframe row, feature)
    with -1 where none."""
    row_of = {int(k): i for i, k in enumerate(m.kf_ids)}
    kf = m.pt_obs_kf
    rows = np.vectorize(lambda k: row_of.get(int(k), -1), otypes=[np.int64])(
        kf) if kf.size else np.zeros(kf.shape, np.int64)
    valid = (kf >= 0) & (rows >= 0)
    order = np.argsort(~valid, axis=1, kind="stable")[:, :GBA_OBS]
    sel_row = np.take_along_axis(np.where(valid, rows, -1), order, 1)
    sel_feat = np.take_along_axis(np.where(valid, m.pt_obs_feat, -1),
                                  order, 1)
    return sel_row, sel_feat


def _kf_terms(m, j: int) -> list:
    """Keyframe row ``j``'s relative-rotation constraints in map ``m``,
    each (A, B, w) with the other keyframe at its final pose: the rotation
    of the BA's residual log(T_j T_i^-1 M^-1) (ops/ba.py) as keyframe j's,
    or, as keyframe i's, the same norm's log(M T_i T_j^-1)."""
    out = []
    R = m.kf_pose[:, :3, :3]
    for i_row, j_row, M, w in m.rpc:
        if j_row == j:
            out.append((np.eye(3), R[i_row].T @ M[:3, :3].T, w))
        elif i_row == j:
            out.append((M[:3, :3], R[j_row].T, w))
    return out


def map_gaps(maps, cameras, sf, dtype=torch.float64, device="cpu",
             seed: int = 0, truth=None, imu: bool = True):
    """(keyframe gaps in mm, the points' excess robust costs, each map's
    keyframe ATE in mm) over the finished sessions' maps: a point seen
    over a short baseline is mm wide along its depth at no cost, so a
    point is judged by cost.  A keyframe's problem holds its
    relative-rotation constraints where the map has them (with ``imu``).
    ``truth`` holds per sequence the true camera centres by frame id
    (session ``k`` ran sequence ``k mod len``); with none there is no ATE.
    The control's ATE is that of its own keyframe solves (the gauge
    keyframes and the weakly seen keep the program's)."""
    kf_out, pt_out, ate_out = [], [], []
    for m in sample(maps, MAX_MAPS, seed + 1):
        camera = cameras[m.session]
        cam, bf = camera[:4], camera[4]
        K = len(m.kf_ids)
        if K < 3 or len(m.pt_ids) == 0:
            continue
        rows, feats = _packed_obs(m)
        ok = rows >= 0
        r0, f0 = np.maximum(rows, 0), np.maximum(feats, 0)
        uv = m.kf_uv[r0, f0].astype(np.float64)
        right = np.where(ok, m.kf_right[r0, f0], -1.0).astype(np.float64)
        octv = m.kf_octave[r0, f0].astype(np.int64)
        # points: each under the final poses of its observers
        poses = m.kf_pose[r0]
        for s in range(0, len(m.pt_ids), 4096):
            sl = slice(s, s + 4096)
            X0 = torch.from_numpy(m.pt_pos[sl]).to(device)
            args = (torch.from_numpy(poses[sl]), torch.from_numpy(uv[sl]),
                    torch.from_numpy(right[sl]), _weights(octv[sl], sf),
                    torch.from_numpy(ok[sl]), cam, bf)
            ref = G.solve_points(X0, *args, torch.float64)
            judged = X0 if dtype == torch.float64 else G.solve_points(
                X0, *args, dtype).double()
            pt_out.append((G.point_costs(judged, *args)
                           - G.point_costs(ref, *args)).cpu().numpy())
        # keyframes: the first and the last are the BA's gauge, held fixed
        T_prog, pts, uvs, rights, octs, js, rel = [], [], [], [], [], [], []
        for j in range(1, K - 1):
            p, f = np.nonzero(ok & (rows == j))
            if len(p) < 10:
                continue
            js.append(j)
            rel.append(_kf_terms(m, j) if imu else [])
            T_prog.append(m.kf_pose[j])
            pts.append(m.pt_pos[p])
            uvs.append(m.kf_uv[j, feats[p, f]])
            rights.append(m.kf_right[j, feats[p, f]])
            octs.append(m.kf_octave[j, feats[p, f]])
        est = G.centres(torch.from_numpy(m.kf_pose.astype(np.float64)))
        if T_prog:
            gaps, judged = _pose_gaps(T_prog, pts, uvs, rights, octs, cam,
                                      bf, sf, dtype, device,
                                      rotation=rel if any(rel) else None)
            kf_out.append(gaps)
            if dtype != torch.float64:
                est[js] = judged
        if truth:
            gt = truth[m.session % len(truth)][m.kf_frame_id]
            ate_out.append(G.ate_mm(est, torch.from_numpy(gt)))
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0))
    return cat(kf_out), cat(pt_out), np.asarray(ate_out, np.float64)


def orb_mismatch(frames, images, orb, dtype=torch.float32) -> np.ndarray:
    """Per sampled frame, % of features not reproduced exactly."""
    from PIL import Image

    from reference import orb as ORB

    out = []
    for f in frames:
        if f.features is None:
            continue
        img = np.asarray(Image.open(images[f.frame_id]), dtype=np.float32)
        ref = ORB.extract(img, orb["n"], orb["levels"], orb["scale_factor"],
                          orb["threshold"], dtype)
        out.append(ORB.mismatch_pct(ref, f.features))
    return np.asarray(out)


def worst(x: np.ndarray) -> float | None:
    return float(np.max(x)) if len(x) else None


def load_number(name: str):
    """The module of a judge number that is not built in:
    ``reference/numbers/<name>.py``.  It defines ``measure(rec, cell,
    runner, dtype, device, seed)``, the per-item readings (an array) of
    the recorded run, which the run is judged by the maximum of unless it
    also defines ``reduce(values)``, and ``READS``: what it reads, one of
    ``READS`` ("frames": tracked frames; "maps": finished sessions' maps
    after ``finalize``; "other").  It may define ``keep_frame(frame)``
    and ``keep_map(system)``: the recorder keeps what they return from
    each recorded frame in ``FrameRec.extra[name]`` and from each session's
    system after ``finalize`` in ``MapRec.extra[name]``.  Like the rest of
    the reference it reads the program's objects handed to it and imports
    nothing of the program."""
    path = NUMBERS / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"judge number {name!r} is not built in, and {path} is missing")
    key = "slambench_number_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod      # where a dataclass in it looks it up
    spec.loader.exec_module(mod)
    if getattr(mod, "READS", None) not in READS:
        raise ValueError(f"judge number {name!r} states no READS of {READS}")
    return mod


def reads(name: str) -> str:
    """What number ``name`` reads: "frames", "maps" or "other"."""
    if name in FRAME_NUMBERS:
        return "frames"
    if name in MAP_NUMBERS:
        return "maps"
    if name in BUILT_IN:
        return "other"
    return load_number(name).READS


def limits_faults(limits: dict) -> list[str]:
    """What keeps a cell's ``limits`` from the rule every cell keeps
    (empty: none): it lists a number, each number listed is built in or
    has its file, and at least one reads tracked frames and one finished
    sessions' maps."""
    if not limits:
        return ["the cell lists no limits"]
    faults, read = [], set()
    for name in limits:
        try:
            read.add(reads(name))
        except (FileNotFoundError, ValueError) as e:
            faults.append(str(e))
    for what, words in (("frames", "tracked frames"),
                        ("maps", "finished sessions' maps")):
        if what not in read:
            faults.append(f"no number listed reads {words}")
    return faults


def file_numbers(numbers) -> dict:
    """{name: module} of the numbers in ``numbers`` that are not built in."""
    return {n: load_number(n) for n in numbers if n not in BUILT_IN}


def default_numbers(images=None, truth=None,
                    loops_per_session: int = 0) -> list[str]:
    """Every built-in number with something to read: the ATE with
    ``truth``, the ORB check with ``images``, the missed loops with
    ``loops_per_session``."""
    skip = {"kf_ate_mm": not truth, "orb_mismatch_pct": images is None,
            "loops_missed": not loops_per_session}
    return [n for n in BUILT_IN if not skip.get(n)]


def measure(rec, config: dict, images=None, dtype=torch.float64,
            device="cpu", seed: int = 0, truth=None, numbers=None,
            cell=None, runner=None, imu: bool = True) -> dict:
    """Per-item readings (arrays) of ``numbers`` (default: every built-in
    one with something to read) over a run, and of what they derive from;
    ``dtype`` below float64 gives the control's.  The pose and point
    solves run on ``device``; frames and maps beyond ``MAX_FRAMES`` and
    ``MAX_MAPS`` are sampled from ``seed``.  ``imu=False`` leaves the
    IMU's terms out of the frames' and keyframes' problems.  A number of a
    module of its own reads ``cell`` and ``runner``."""
    if numbers is None:
        numbers = default_numbers(images, truth)
    want = set(numbers)
    if "frame_excess_chi2_mean" in want:
        want.add("frame_excess_chi2")
    cameras = rec.cameras
    fd = config["ini"]["FeatureDetector"]
    sf = float(fd["fd_scale_factor"])
    out = {}
    if "frame_excess_chi2" in want:
        out["frame_excess_chi2"] = frame_excess(rec.frames, cameras, sf,
                                                dtype, device, seed, imu)
    if "init_gap_mm" in want:
        out["init_gap_mm"] = init_gaps(rec.frames, cameras, dtype)
    if want & set(MAP_NUMBERS):
        got = map_gaps(rec.maps, cameras, sf, dtype, device, seed, truth,
                       imu)
        out.update((n, v) for n, v in zip(MAP_NUMBERS, got) if n in want)
    if "orb_mismatch_pct" in want:
        orb = dict(n=int(fd["fd_features"]), levels=int(fd["fd_levels"]),
                   scale_factor=sf, threshold=float(fd["fd_ini_th_fast"]))
        low = torch.float32 if dtype == torch.float64 else dtype
        out["orb_mismatch_pct"] = (np.zeros(0) if images is None else
                                   orb_mismatch(rec.frames, images, orb, low))
    for name, mod in file_numbers(numbers).items():
        out[name] = np.asarray(mod.measure(rec, cell, runner, dtype, device,
                                           seed), dtype=np.float64)
    return out


def readings(rec, config: dict, images=None, dtype=torch.float64,
             device="cpu", seed: int = 0, loops_per_session: int = 0,
             truth=None, numbers=None, cell=None, runner=None,
             imu: bool = True) -> dict:
    """The numbers a run is judged by, each of ``numbers`` (default: every
    built-in one with something to read) and no other: a worst case of
    ``measure``'s readings, the frames' mean excess, or the sessions that
    missed one of ``loops_per_session`` loops; a number of a module of its
    own by its ``reduce``.  None where there is nothing to read."""
    if numbers is None:
        numbers = default_numbers(images, truth, loops_per_session)
    got = measure(rec, config, images, dtype, device, seed, truth, numbers,
                  cell, runner, imu)
    out = {}
    for name in BUILT_IN:
        if name not in numbers:
            continue
        if name == "frame_excess_chi2_mean":
            fr = got["frame_excess_chi2"]
            out[name] = float(np.mean(fr)) if len(fr) else None
        elif name == "loops_missed":
            # the traffic revisits its start once a session: a finished
            # session that closed fewer loops missed one
            out[name] = (sum(m.loops < loops_per_session for m in rec.maps)
                         if rec.maps and loops_per_session else None)
        else:
            out[name] = worst(got[name])
    for name, mod in file_numbers(numbers).items():
        out[name] = getattr(mod, "reduce", worst)(got[name])
    return out
