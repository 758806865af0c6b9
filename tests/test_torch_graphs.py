"""The graph layer (``snakeslam_tpu_torch/utils/graphs.py``) on the CPU.

On CPU tensors a compiled program runs its function as it is, so these
tests hold what the CPU can show: the cache key (static values, argument
structure, shapes, dtypes, device, thread; a by-reference argument's
storage address and strides), eager calls equal to the plain function for
every program the port compiles (exactly: the same function runs), on the
inputs of ``utils/graph_cases.py``, and each program's key separating its
statics; the pool programs equal the searches they wrap on the gathered
rows; ``disabled()`` nesting, the launch tally outside a capture, device
constants and the argument trees.  Captures and replays run on the card
only (``tests/test_torch_cuda.py``).  This file imports no JAX.
"""

import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

from snakeslam_tpu_torch.entry import entry
from snakeslam_tpu_torch.models import tracking_step as TS
from snakeslam_tpu_torch.models import window_step as WS
from snakeslam_tpu_torch.optim import lba as LBA
from snakeslam_tpu_torch.utils import graph_cases as GC
from snakeslam_tpu_torch.utils import graphs
from snakeslam_tpu_torch.utils.backend_problems import ba_problem

# each queue-D program with one static value changed
STATIC_VARIANTS = {
    "orb": dict(threshold=21.0),
    "orb_batch": dict(levels=3),
    "stereo_frontend": dict(bf=41.0),
    "imu_chain_solve": dict(solve_scale=False),
    "triangulate_pool": dict(feature_distance=49),
    "fuse_pool": dict(levels=3),
    "fuse_pool_row": dict(bounds=(0.0, 0.0, 320.0, 240.0)),
    "fuse_search_single": dict(th=1.0),
    "gba_full_ba": dict(iterations=3),
    "gba_point_ba": dict(iterations=3),
    "gba_outliers": dict(chi2_mono=4.0),
    "pgo": dict(use_sim3=True),
}


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def _affine(x, pair, scale: float = 2.0, shift: bool = False):
    y = x * scale + pair.a.sum() - pair.b.mean()
    return {"y": y + 1.0 if shift else y, "pair": Pair(pair.b, pair.a)}


PROG = graphs.compiled(_affine, static=("scale", "shift"), name="affine")


def _args(n=4, dtype=torch.float32):
    x = torch.arange(n, dtype=dtype)
    return x, Pair(torch.ones(3, dtype=dtype), torch.zeros(2, dtype=dtype))


def test_key_separates_static_values_shapes_dtypes_and_structure():
    x, pair = _args()
    key = PROG.key(x, pair)
    assert PROG.key(x, pair) == key
    # defaults bind as named: the same key either way
    assert PROG.key(x, pair, scale=2.0, shift=False) == key
    # equal shapes and dtypes hit, whatever the values
    assert PROG.key(x + 5.0, Pair(pair.a * 3, pair.b)) == key
    others = [
        PROG.key(x, pair, scale=3.0),
        PROG.key(x, pair, shift=True),
        PROG.key(torch.arange(5.0), pair),
        PROG.key(x.double(), pair),
        PROG.key(x, Pair(torch.ones(4), pair.b)),
        PROG.key(x, (pair.a, pair.b)),           # a tuple, not a Pair
    ]
    assert len({key, *others}) == len(others) + 1
    statics, desc, device, thread = key
    assert statics == (("scale", 2.0), ("shift", False))
    assert device == torch.device("cpu")
    assert thread == threading.get_ident()


def test_key_holds_the_thread():
    x, pair = _args()
    keys = []
    t = threading.Thread(target=lambda: keys.append(PROG.key(x, pair)))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and len(keys) == 1
    assert keys[0] != PROG.key(x, pair)
    assert keys[0][:3] == PROG.key(x, pair)[:3]


def test_cpu_calls_run_the_function_as_it_is():
    x, pair = _args()
    out = PROG(x, pair, scale=0.5, shift=True)
    ref = _affine(x, pair, scale=0.5, shift=True)
    assert torch.equal(out["y"], ref["y"])
    assert type(out["pair"]) is Pair
    assert torch.equal(out["pair"].a, pair.b)
    # Python values beside CPU tensors pass through as the function takes
    # them (on the card they must be static or tensors)
    assert torch.equal(graphs.compiled(lambda v, k: v * k)(x, 3), x * 3)
    s = graphs.stats()["affine"]
    assert (s["captures"], s["replays"], s["entries"]) == (0, 0, 0)


def test_unknown_static_name_raises():
    with pytest.raises(ValueError, match="not parameters"):
        graphs.compiled(_affine, static=("scales",))


def test_disabled_nests_and_restores():
    assert not graphs.is_disabled()
    with graphs.disabled():
        assert graphs.is_disabled()
        with graphs.disabled():
            assert graphs.is_disabled()
        assert graphs.is_disabled()
    assert not graphs.is_disabled()
    with pytest.raises(RuntimeError):
        with graphs.disabled():
            raise RuntimeError("inside")
    assert not graphs.is_disabled()


def test_count_adds_outside_a_capture():
    seen = []
    graphs.count(seen.append)
    graphs.count(seen.append, 3)
    assert seen == [1, 3]


def test_argument_trees_round_trip():
    leaves, values = [], []
    tree = {"p": Pair(torch.ones(2), torch.zeros(3)),
            "l": [torch.arange(3), None], "t": (torch.eye(2),), "v": 7}
    desc = graphs._flatten(tree, leaves, values)
    assert len(leaves) == 4 and values == [7]
    hash(desc)
    back = graphs._rebuild(desc, iter(leaves))
    assert type(back["p"]) is Pair and back["l"][1] is None
    assert back["v"] == 7 and back["t"][0] is leaves[-1]


def test_the_ports_programs_are_registered():
    import importlib

    assert isinstance(WS.window_track, graphs.Compiled)
    # each call site the system uses is the registered program
    for name, (module, attr) in GC.SITES.items():
        prog = getattr(importlib.import_module(module), attr)
        assert isinstance(prog, graphs.Compiled) and prog.name == name
    names = {p.name for p in graphs.programs()}
    assert {"window_track", "coarse_step", "fine_step", "lba_solve"} | {
        GC.program_of(n) for n in STATIC_VARIANTS} <= names


def test_by_reference_arguments_key_on_their_storage():
    def gather(table, rows, k: int = 1):
        return table[rows] * k

    prog = graphs.compiled(gather, static=("k",), by_ref=("table",),
                           name="gather_by_ref")
    table = torch.arange(12.0).reshape(6, 2)
    rows = torch.tensor([4, 1])
    key = prog.key(table, rows)
    # the same storage: the same key, whatever it holds now
    assert prog.key(table.add_(1.0), rows + 1) == key
    others = [prog.key(table.clone(), rows),             # another address
              prog.key(table.t().contiguous().t(), rows),  # other strides
              prog.key(table[1:], rows),                  # another offset
              prog.key(table, rows, k=2)]
    assert len({key, *others}) == len(others) + 1
    # only the by-reference argument keys on its address
    assert prog.key(table, rows.clone()) == key
    assert torch.equal(prog(table, rows, k=3), gather(table, rows, k=3))
    with pytest.raises(ValueError, match="both static and by_ref"):
        graphs.compiled(gather, static=("table",), by_ref=("table",))
    with pytest.raises(ValueError, match="not parameters"):
        graphs.compiled(gather, by_ref=("tables",))


def test_constants_are_made_once_per_key_and_device():
    made = []

    def make():
        made.append(1)
        return np.arange(3, dtype=np.int64)

    a = graphs.constant(("test_constant", 3), "cpu", make)
    b = graphs.constant(("test_constant", 3), torch.device("cpu"), make)
    assert a is b and len(made) == 1
    assert torch.equal(a, torch.arange(3))


@pytest.fixture(scope="module")
def cases():
    return GC.program_cases("cpu")


def _leaves(tree):
    leaves = []
    graphs._flatten(tree, leaves, [])
    return leaves


@pytest.mark.parametrize("name", sorted(STATIC_VARIANTS))
def test_queue_d_program_on_the_cpu_equals_the_plain_function(cases, name):
    prog, args, kw = cases[name]
    assert prog.name == GC.program_of(name)
    out, ref = _leaves(prog(*args, **kw)), _leaves(prog.fn(*args, **kw))
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", sorted(STATIC_VARIANTS))
def test_queue_d_program_keys_separate_their_statics(cases, name):
    prog, args, kw = cases[name]
    key = prog.key(*args, **kw)
    assert prog.key(*GC._copy(args), **GC._copy(kw)) == key or \
        prog.by_ref           # a by-reference copy is another address
    variant = {**kw, **STATIC_VARIANTS[name]}
    other = prog.key(*args, **variant)
    assert other != key and other[1:] == key[1:]
    statics = dict(key[0])
    assert set(statics) == set(prog.static)
    for k, v in STATIC_VARIANTS[name].items():
        assert dict(other[0])[k] == v


def test_pool_programs_equal_the_searches_on_gathered_rows(cases):
    from snakeslam_tpu_torch.map.kf_pool import pool_features
    from snakeslam_tpu_torch.mapping import fusion as FUS
    from snakeslam_tpu_torch.ops.triangulate_pairs import (
        triangulate_pairs_batch)

    prog, (pool, slots, *rest), kw = cases["triangulate_pool"]
    free_a, free_b, T_a, T_b, cam, bf, scales, inv_sigma2, grid, th = rest
    assert prog.by_ref == {"pool"} and prog.clone
    out = prog(pool, slots, *rest, **kw)
    ref = triangulate_pairs_batch(
        pool_features(pool, slots[:1]).__class__(
            *(f[0] for f in pool_features(pool, slots[:1]))),
        pool_features(pool, slots[1:]), free_a, free_b, T_a, T_b, cam, bf,
        scales, inv_sigma2, grid_a=grid, th_depth=th, **kw)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    for name in ("fuse_pool", "fuse_pool_row"):
        prog, (pool, slots, lm, pose), kw = cases[name]
        feats = pool_features(pool, slots)
        ref = FUS._fuse_search(lm, feats, pose, **kw)
        assert torch.equal(prog(pool, slots, lm, pose, **kw), ref), name
        assert ref.shape == feats.valid.shape


def test_fine_step_on_the_cpu_equals_the_plain_function():
    fn, args = entry("cpu")
    out = TS.fine_step(*args)
    ref = TS._fine_step(*args)
    for k in ("T", "fine_assign", "inlier", "n_inliers", "packed"):
        assert torch.equal(out[k], ref[k]), k


def test_coarse_step_on_the_cpu_equals_the_plain_function():
    _, args = entry("cpu")
    lm, frame, eye, _, _, cam, bf, bounds, scales, log_sf, th, _, w, _ = args
    for hist in (True, False):
        kw = dict(use_rotation_hist=hist)
        out = TS.coarse_step(lm, frame, eye, cam, bf, bounds, scales,
                             log_sf, th, w, w, **kw)
        ref = TS._coarse_step(lm, frame, eye, cam, bf, bounds, scales,
                              log_sf, th, w, w, **kw)
        for k in ("T", "assign", "n_matches", "packed"):
            assert torch.equal(out[k], ref[k]), (hist, k)


def test_lba_program_on_the_cpu_equals_the_plain_solve():
    prob, cam, bf = ba_problem(8, 128, 4, 0, "cpu")
    out = LBA.solve_window(prob, cam, bf, iterations=2)
    ref = LBA._solve_window(prob, cam, bf, iterations=2)
    assert len(out) == 3
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert np.isfinite(out[0].numpy()).all()
    assert out[2].shape == prob.obs_valid.shape


def test_max_entries_bounds_each_program():
    assert PROG.max_entries == graphs.MAX_ENTRIES >= 1
    assert graphs.compiled(_affine, max_entries=2).max_entries == 2
    with pytest.raises(ValueError, match="max_entries"):
        graphs.compiled(_affine, max_entries=0)
    s = graphs.stats()["affine"]
    assert s["evictions"] == 0 and s["pool_mib"] == 0
    # the programs whose graphs share one pool per thread clone their
    # outputs (see the module docstring)
    for name in ("lba_solve", "triangulate_pool", "fuse_pool",
                 "gba_full_ba", "gba_point_ba", "gba_outliers"):
        prog, = [p for p in graphs.programs() if p.name == name]
        assert prog.clone, name


def _unpadded(graph):
    from snakeslam_tpu_torch.ops import pgo as PGO

    V, E = int(graph.valid.sum()), int(graph.edge_valid.sum())
    return PGO.PoseGraph(*(f[:V] if i < 3 else f[:E]
                           for i, f in enumerate(graph)))


def test_padded_pose_graph_solves_as_the_exact_graph(cases):
    from snakeslam_tpu_torch.ops import pgo as PGO

    prog, (graph,), kw = cases["pgo"]
    exact = _unpadded(graph)
    V, E = exact.poses.shape[0], exact.edge_i.shape[0]
    assert graph.poses.shape[0] == PGO.bucket(V) > V
    assert graph.edge_i.shape[0] == PGO.bucket(E) > E
    for use_sim3 in (False, True):
        kw = dict(kw, use_sim3=use_sim3)
        poses, cost = prog(graph, **kw)
        ref, ref_cost = PGO._solve_pgo(exact, **kw)
        assert torch.allclose(poses[:V], ref, rtol=0, atol=1e-9)
        assert torch.allclose(cost, ref_cost, rtol=1e-9, atol=1e-15)
        # the pad vertices stay the identity
        assert torch.equal(poses[V:], graph.poses[V:])
        assert not torch.equal(poses[:V], graph.poses[:V])


def test_padded_pose_graphs_share_a_key_within_a_bucket():
    from snakeslam_tpu_torch.ops import pgo as PGO

    def graph(V, E):
        rng = np.random.default_rng(V + E)
        return PGO.PoseGraph(**{k: torch.from_numpy(a) for k, a in PGO.padded(
            np.broadcast_to(np.eye(4), (V, 4, 4)).copy(),
            np.arange(V) == 0, rng.integers(0, V, E), rng.integers(0, V, E),
            np.broadcast_to(np.eye(4), (E, 4, 4)).copy(),
            np.ones(E)).items()})

    key = PGO.solve_pgo.key(graph(17, 40), iterations=25)
    assert PGO.solve_pgo.key(graph(32, 64), iterations=25) == key
    assert PGO.solve_pgo.key(graph(33, 64), iterations=25) != key
    assert PGO.solve_pgo.key(graph(20, 65), iterations=25) != key
    assert [PGO.bucket(n) for n in (1, 16, 17, 100)] == [16, 16, 32, 128]
