"""Lane traces (``snakeslam_tpu_torch/utils/lane_trace.py``).

The committed trace file loads: the JAX package's traces of the mono-VI
(full width and small), loop lanes (``scripts/jax_lane_trace.py``) with
their counts equal to the JAX runs the chip lanes are gated on, and the
port's CPU traces of the same lanes.  ``first_parting`` names the earliest
difference by frame.  The port's recorder on the small mono-VI twin (80
frames of tests/test_torch_mono_vi_slice.py's configuration, float64
draws) reproduces its committed trace: every attempt, landing, keyframe
cycle and count equal, keyframe centres within 1e-6 m.
"""

import copy

import numpy as np
import pytest
import torch

from snakeslam_tpu_torch.utils import lane_trace as LT


def test_committed_traces_load():
    ref = LT.load()
    for group in ("jax", "port_cpu"):
        for lane in ("mono_vi", "mono_vi_small", "loop"):
            t = ref[group][lane]
            assert t["lane"]["name"] == lane
            assert {"attempts", "landed", "cycles", "loops", "run"} <= set(t)
            assert all(len(c) == 6 for c in t["cycles"])
    # the JAX runs the chip lanes are gated on (PERF.md section 2)
    jm, jl = ref["jax"]["mono_vi"], ref["jax"]["loop"]
    assert (jm["run"]["tracked"], jm["run"]["keyframes"],
            jm["run"]["points"]) == (237, 20, 2540)
    assert jm["landed"] == dict(mono_init=4, gyro=79, gravity=100)
    assert jm["run"]["draw"] == "float64"
    assert (jl["run"]["tracked"], jl["run"]["keyframes"],
            jl["run"]["points"]) == (400, 81, 6280)
    assert jl["final"]["keyframes"] == 71 and jl["run"]["draw"] == "float32"
    assert any(lp[5] for lp in jl["loops"])        # a verified loop


def test_first_parting_orders_by_frame():
    t = dict(attempts=[[1, 4, 300, 120]],
             landed=dict(mono_init=4, gyro=79, gravity=100),
             cycles=[[10, 3, 500, 0.0, 0.0, 0.0],
                     [20, 4, 600, 1.0, 0.0, 0.0],
                     [90, 5, 700, 2.0, 0.0, 0.0]],
             loops=[], run=dict(tracked=9, keyframes=5, points=700))
    assert LT.first_parting(t, t)["parting"] is None
    u = copy.deepcopy(t)
    u["cycles"][1][3] += 1e-3          # a centre alone does not part
    u["cycles"][2][2] += 1             # a point count does, at frame 90
    u["landed"]["gyro"] = 80           # ... after the gyro stage, at 79
    out = LT.first_parting(t, u)
    assert out["parting"] == dict(frame=79, what="landed", index="gyro",
                                  a=79, b=80)
    assert out["cycles_compared"] == 2
    assert out["max_centre_diff_m"] == pytest.approx(1e-3)
    u["landed"]["gyro"] = 79
    assert LT.first_parting(t, u)["parting"]["what"] == "cycle"
    v = copy.deepcopy(t)
    v["attempts"].append([4, 5, 310, None])
    assert LT.first_parting(t, v)["parting"]["frame"] == 5


def test_small_twin_reproduces_its_committed_trace():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trace = LT.run_lane("mono_vi_small", "cpu")
    finally:
        torch.set_num_threads(n)
    ref = LT.load()["port_cpu"]["mono_vi_small"]
    out = LT.first_parting(trace, ref)
    assert out["parting"] is None, out
    assert out["cycles_compared"] == len(ref["cycles"]) > 0
    assert trace["attempts"] == ref["attempts"] and trace["attempts"]
    np.testing.assert_allclose(np.array(trace["cycles"])[:, 3:],
                               np.array(ref["cycles"])[:, 3:], atol=1e-6)
    for k in ("tracked", "keyframes", "points", "draw"):
        assert trace["run"][k] == ref["run"][k]
    assert trace["run"]["ate_m"] == pytest.approx(ref["run"]["ate_m"],
                                                  abs=1e-6)
