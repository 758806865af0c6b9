"""Seeded inputs for the compiled programs of the back-end, the
front-ends, the IMU solver, loop closing and the global BA.

``program_cases(device)`` returns ``{name: (program, args, kwargs)}``:

- ``orb``, ``orb_batch``, ``stereo_frontend``: a seeded 96 x 128 image
  (and a stereo pair of them, the right view shifted 4 px), two levels;
- ``imu_chain_solve``: the 12-keyframe chain of ``vi_problems
  .chain_arrays`` in a 16-slot bucket, float64, scale solved;
- ``triangulate_pool``, ``fuse_pool``, ``fuse_pool_row``,
  ``fuse_search_single``: the drifted loop ring of ``loop_problems``
  (20 keyframes, 1024 feature slots): the newest keyframe's triangulation
  and fusion (``LocalMapper._tri_dispatch``, ``MapSearcher.dispatch``:
  ``fuse_pool`` into the 16 neighbour rows, ``fuse_pool_row`` the same
  program into the keyframe's own row) and SearchAndFuse of the first
  keyframe's points into it (``th = 4``), each recorded where the system
  calls it (``recording``);
- ``pgo``: that ring's keyframe poses as an SE3 pose graph (consecutive
  edges measured before the drift, the first keyframe fixed), padded as
  loop closing pads it (``pgo.padded``);
- ``gba_full_ba``, ``gba_point_ba``, ``gba_outliers``: the seeded
  ``backend_problems.ba_problem`` (C 8, P 128, M 4) in float64.

Used by ``tests/test_torch_graphs.py`` (on the CPU) and
``tests/test_torch_cuda.py`` (on the card).
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

# program name -> (module, attribute) of the site the system calls it at
SITES = {
    "imu_chain_solve": ("snakeslam_tpu_torch.ops.imu", "solve_imu_chain"),
    "orb": ("snakeslam_tpu_torch.frontend.feature_detector", "extract_orb"),
    "stereo_frontend": ("snakeslam_tpu_torch.frontend.pixels",
                        "stereo_frontend_batch"),
    "triangulate_pool": ("snakeslam_tpu_torch.mapping.local_mapping",
                         "triangulate_pool"),
    "fuse_pool": ("snakeslam_tpu_torch.mapping.fusion", "fuse_pool"),
    "fuse_search_single": ("snakeslam_tpu_torch.mapping.fusion",
                           "fuse_search_single"),
    "gba_full_ba": ("snakeslam_tpu_torch.optim.gba", "full_ba_solve"),
    "gba_point_ba": ("snakeslam_tpu_torch.optim.gba", "point_ba_solve"),
    "gba_outliers": ("snakeslam_tpu_torch.optim.gba", "outlier_classify"),
    "pgo": ("snakeslam_tpu_torch.loop.loop_closing", "solve_pgo"),
}

RING_PROGRAMS = ("triangulate_pool", "fuse_pool", "fuse_search_single")

# a case that is another call of a program: case -> the program's name
CASE_PROGRAM = {"fuse_pool_row": "fuse_pool"}


def program_of(case: str) -> str:
    """The name of the program the case ``case`` calls."""
    return CASE_PROGRAM.get(case, case)


def _copy(x):
    """A copy of an argument tree (tensors cloned, other leaves kept)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def recording(names):
    """While inside, each named program's call site keeps a copy of the
    arguments of each call: yields {name: [(program, args, kwargs), ...]},
    filled as the programs are called."""
    kept, restore = {}, []
    for name in names:
        module = importlib.import_module(SITES[name][0])
        attr = SITES[name][1]
        prog = getattr(module, attr)

        def wrapped(*a, _name=name, _prog=prog, **k):
            kept.setdefault(_name, []).append((_prog, _copy(a), _copy(k)))
            return _prog(*a, **k)

        setattr(module, attr, wrapped)
        restore.append((module, attr, prog))
    try:
        yield kept
    finally:
        for module, attr, prog in restore:
            setattr(module, attr, prog)


def image_cases(device, seed: int = 3) -> dict:
    """The ORB programs and the stereo front-end on seeded images."""
    from snakeslam_tpu_torch.frontend import pixels as PIX
    from snakeslam_tpu_torch.ops import orb as ORB

    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (96, 132)).astype(np.float32)
    left = torch.from_numpy(img[:, 4:]).to(device)
    right = torch.from_numpy(img[:, :-4]).to(device)
    orb_kw = dict(n_features=96, levels=2, scale_factor=1.2, threshold=20.0)
    pair = torch.stack([left, right])
    return dict(
        orb=(ORB.extract_orb, (left,), dict(orb_kw)),
        orb_batch=(ORB.extract_orb_batch, (pair,), dict(orb_kw)),
        stereo_frontend=(PIX.stereo_frontend_batch,
                         (left[None].to(torch.uint8),
                          right[None].to(torch.uint8)),
                         dict(bf=40.0, relaxed=False, **orb_kw)))


def chain_case(device) -> dict:
    """The chain solve on ``vi_problems.chain_arrays(12, 16)``."""
    from snakeslam_tpu_torch.ops import imu as IMU
    from snakeslam_tpu_torch.utils import vi_problems as VP

    arrays = VP.chain_arrays(12, 16)
    arrays.pop("v_true")
    chain = IMU.ImuChain(**{
        k: torch.from_numpy(np.ascontiguousarray(
            a if a.dtype == bool else a.astype(np.float64))).to(device)
        for k, a in arrays.items()})
    f64 = dict(dtype=torch.float64, device=device)
    z = torch.zeros(3, **f64)
    args = (chain, z, z.clone(), torch.tensor([0.3, -0.2, -9.71], **f64),
            torch.full((), 1.2, **f64))
    return dict(imu_chain_solve=(IMU.solve_imu_chain, args, dict(
        solve_scale=True, iterations=4, prior_bias_weight=10.0)))


def ring_cases(device) -> dict:
    """The ring's keyframe cycle, SearchAndFuse and pose graph."""
    from snakeslam_tpu_torch.mapping.local_mapping import LocalMapper
    from snakeslam_tpu_torch.ops import pgo as PGO
    from snakeslam_tpu_torch.tracking.staging import upload
    from snakeslam_tpu_torch.utils import loop_problems as LP

    smap, s, _, _ = LP.build_ring()
    before = smap.kf_pose.copy()
    new_side, _ = LP.drift_newest(smap)
    kf, first = int(new_side[-1]), int(smap.valid_keyframes()[0])
    with recording(RING_PROGRAMS) as calls:
        mapper = LocalMapper(s, smap, device)
        mapper._tri_dispatch(kf)
        mapper.map_searcher.dispatch(kf)
        mapper.map_searcher._fuse_points_into_kf(
            smap.keyframe_points(first), kf, th=4.0)
    kept = {n: c[0] for n, c in calls.items()}
    rows = {len(a[1]): (p, a, k) for p, a, k in calls.get("fuse_pool", [])}
    if 1 in rows:
        kept["fuse_pool"] = max(rows.items())[1]
        kept["fuse_pool_row"] = rows[1]
    missing = (set(RING_PROGRAMS) | set(CASE_PROGRAM)) - set(kept)
    if missing or len(rows) < 2:
        raise RuntimeError(f"the ring scene never called {sorted(missing)}"
                           f" (fuse_pool with rows {sorted(rows)})")
    kfs = smap.valid_keyframes()
    kfs = kfs[np.argsort(smap.kf_frame_id[kfs])]
    V = len(kfs)
    rel = np.stack([before[kfs[i + 1]] @ np.linalg.inv(before[kfs[i]])
                    for i in range(V - 1)])
    graph = PGO.PoseGraph(**{k: upload(a, device) for k, a in PGO.padded(
        smap.kf_pose[kfs].astype(np.float64), np.arange(V) == 0,
        np.arange(V - 1), np.arange(1, V), rel.astype(np.float64),
        np.ones(V - 1)).items()})
    kept["pgo"] = (PGO.solve_pgo, (graph,), dict(iterations=5,
                                                   use_sim3=False))
    return kept


def gba_cases(device) -> dict:
    """The three global-BA passes on a seeded float64 BA problem."""
    from snakeslam_tpu_torch.core.camera import Pinhole
    from snakeslam_tpu_torch.ops.ba import BAProblem
    from snakeslam_tpu_torch.optim import gba as GBA
    from snakeslam_tpu_torch.utils.backend_problems import ba_problem

    prob, cam, bf = ba_problem(8, 128, 4, 0, device)
    prob = BAProblem(*(t.double() if t.is_floating_point() else t
                       for t in prob))
    cam = Pinhole(*(c.double() for c in cam))
    bf = bf.double()
    return dict(
        gba_full_ba=(GBA.full_ba_solve, (prob, cam, bf),
                     dict(iterations=2)),
        gba_point_ba=(GBA.point_ba_solve, (prob, cam, bf),
                      dict(iterations=2)),
        gba_outliers=(GBA.outlier_classify,
                      (prob, cam, bf, prob.cam_pose, prob.points),
                      dict(chi2_mono=0.75 * 2.1 ** 2,
                           chi2_stereo=0.75 * 2.3 ** 2)))


def program_cases(device) -> dict:
    """{name: (program, args, kwargs)} for every program above."""
    return {**image_cases(device), **chain_case(device), **ring_cases(device),
            **gba_cases(device)}
