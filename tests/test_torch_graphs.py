"""The graph layer (``snakeslam_tpu_torch/utils/graphs.py``) on the CPU.

On CPU tensors a compiled program runs its function as it is, so these
tests hold what the CPU can show: the cache key (static values, argument
structure, shapes, dtypes, device, thread), eager calls equal to the plain
function for the four programs the port compiles (exactly: the same
function runs), ``disabled()`` nesting, the launch tally outside a
capture, and the argument trees.  Captures and replays run on the card
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
from snakeslam_tpu_torch.utils import graphs
from snakeslam_tpu_torch.utils.backend_problems import ba_problem


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
    assert isinstance(WS.window_track, graphs.Compiled)
    names = {p.name for p in graphs.programs()}
    assert {"window_track", "coarse_step", "fine_step",
            "lba_solve"} <= names


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
