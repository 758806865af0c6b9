"""Port parity: ops/matching.py against snakeslam_tpu.ops.matching.

Seeded local-map snapshots and frames from the synthetic world go through
both packages as float32 / int32 inputs.  The projection matchers must
give identical ``feat_point`` and ``visible`` on >= 99.5% of entries
(projection and distance gates are f32 comparisons that can flip at an
exact boundary); the segment-min commit and the rotation filter are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.ops import matching as jm
from snakeslam_tpu.ops.descriptors import unpack_bits_np
from snakeslam_tpu.utils.synthetic import SyntheticWorld, orbit_trajectory
from snakeslam_tpu_torch.ops import matching as tm
from snakeslam_tpu_torch.utils.convert import (
    frame_features_from_numpy,
    local_map_from_numpy,
    pinhole_from_numpy,
)

P_SLOTS, N_SLOTS = 1024, 512


def _scene(seed):
    """(lm, frame, T_pred, world) as numpy NamedTuples: the snapshot holds
    the points seen from pose 0 with their pose-0 keypoint payload; the
    frame is observed from a later pose of the orbit."""
    world = SyntheticWorld(n_points=1500, seed=seed)
    traj = list(orbit_trajectory(40, radius=7.0, arc=0.2, fps=20.0))
    T0 = traj[0][1]
    T1 = traj[6][1]
    f0 = world.observe(T0, max_features=P_SLOTS, n_clutter=0,
                       with_stereo=True)
    f1 = world.observe(T1, max_features=N_SLOTS, with_stereo=True)
    pid = f0.point_id
    n = len(pid)
    pos = world.points[pid]
    cam0 = -T0[:3, :3].T @ T0[:3, 3]
    nrm = cam0 - pos
    dist = np.linalg.norm(nrm, axis=1)
    P = P_SLOTS
    lm = jm.LocalMapPoints(
        position=np.zeros((P, 3), np.float32),
        normal=np.zeros((P, 3), np.float32),
        desc_bits=np.zeros((P, 256), np.int8),
        ref_depth=np.ones(P, np.float32),
        ref_level=np.zeros(P, np.int32),
        angle=np.zeros(P, np.float32),
        valid=np.arange(P) < n,
    )
    lm.position[:n] = pos
    lm.normal[:n] = nrm / dist[:, None]
    lm.desc_bits[:n] = unpack_bits_np(world.descriptors[pid])
    lm.ref_depth[:n] = dist
    lm.ref_level[:n] = f0.octave
    lm.angle[:n] = f0.angle
    N = N_SLOTS
    m = min(f1.n, N)
    fr = jm.FrameFeatures(
        uv=np.zeros((N, 2), np.float32),
        right=np.full(N, -1.0, np.float32),
        octave=np.zeros(N, np.int32),
        angle=np.zeros(N, np.float32),
        desc_bits=np.zeros((N, 256), np.int8),
        valid=np.arange(N) < m,
    )
    fr.uv[:m] = f1.uv[:m]
    fr.right[:m] = f1.right[:m]
    fr.octave[:m] = f1.octave[:m]
    fr.angle[:m] = f1.angle[:m]
    fr.desc_bits[:m] = unpack_bits_np(f1.descriptors[:m])
    return lm, fr, T1.astype(np.float32), world


def _common(world):
    pyr = ScalePyramid.create(world.levels, world.scale_factor)
    cam = (world.fx, world.fy, world.cx, world.cy)
    bounds = (0.0, 0.0, float(world.image_size[0]), float(world.image_size[1]))
    jst = jm.ScaleTables(scales=jnp.asarray(pyr.scales),
                         log_scale_factor=jnp.float32(pyr.log_scale_factor),
                         levels=pyr.levels)
    tst = tm.ScaleTables.from_pyramid(pyr)
    jargs = (JPinhole(*(jnp.float32(c) for c in cam)), jnp.float32(world.bf),
             tuple(jnp.float32(b) for b in bounds), jst)
    targs = (pinhole_from_numpy(cam, "cpu"),
             torch.tensor(world.bf, dtype=torch.float32),
             tuple(torch.tensor(b) for b in bounds), tst)
    return jargs, targs


def _as_jax(nt):
    return type(nt)(*(jnp.asarray(a) for a in nt))


def _agree(a, b):
    return (np.asarray(a) == b.numpy()).mean()


@pytest.mark.parametrize("seed", [101, 102])
@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_projection_search_parity(seed, stage):
    lm, fr, T, world = _scene(seed)
    # a predicted pose off by a few millimetres, as the tracker hands over
    T = T.copy()
    T[:3, 3] += np.float32([3e-3, -2e-3, 4e-3])
    (jcam, jbf, jb, jst), (tcam, tbf, tb, tst) = _common(world)
    jlm, jfr = _as_jax(lm), _as_jax(fr)
    tlm = local_map_from_numpy(lm, "cpu")
    tfr = frame_features_from_numpy(fr, "cpu")
    if stage == "coarse":
        kw = dict(th=10.0, feature_error=75, use_rotation_hist=True)
        jo = jm.search_by_projection_coarse(jlm, jfr, jnp.asarray(T), jcam,
                                            jbf, jb, jst,
                                            feat_free=jfr.valid, **kw)
        to = tm.search_by_projection_coarse(tlm, tfr, torch.from_numpy(T),
                                            tcam, tbf, tb, tst,
                                            feat_free=tfr.valid, **kw)
    else:
        kw = dict(th=4.0, ratio=0.8)
        jo = jm.search_by_projection_fine(jlm, jfr, jnp.asarray(T), jcam, jbf,
                                          jb, jst, feat_free=jfr.valid, **kw)
        to = tm.search_by_projection_fine(tlm, tfr, torch.from_numpy(T), tcam,
                                          tbf, tb, tst, feat_free=tfr.valid,
                                          **kw)
    assert int(to["n_matches"]) > 100
    assert _agree(jo["feat_point"], to["feat_point"]) >= 0.995
    assert _agree(jo["visible"], to["visible"]) >= 0.995
    assert to["feat_point"].dtype == torch.int32


def test_resolve_matches_exact():
    rng = np.random.default_rng(7)
    P, N = 700, 300
    best_feat = rng.integers(0, N, size=P).astype(np.int32)
    best_dist = rng.integers(0, 40, size=P).astype(np.int32)  # many ties
    ok = rng.random(P) < 0.8
    jf = jm._resolve_matches(jnp.asarray(best_feat), jnp.asarray(best_dist),
                             jnp.asarray(ok), N)
    tf = tm._resolve_matches(torch.from_numpy(best_feat),
                             torch.from_numpy(best_dist),
                             torch.from_numpy(ok), N)
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert (tf.numpy() >= 0).sum() > 200


def test_rotation_consistency_filter_exact():
    rng = np.random.default_rng(8)
    P, N = 400, 300
    feat_point = np.where(rng.random(N) < 0.7,
                          rng.integers(0, P, size=N), -1).astype(np.int32)
    point_angle = rng.uniform(0, 360, P).astype(np.float32)
    feat_angle = point_angle[np.maximum(feat_point, 0)] - np.where(
        rng.random(N) < 0.8, 12.0, rng.uniform(0, 360, N)).astype(np.float32)
    feat_angle = np.mod(feat_angle, 360).astype(np.float32)
    jf = jm.rotation_consistency_filter(jnp.asarray(feat_point),
                                        jnp.asarray(point_angle),
                                        jnp.asarray(feat_angle))
    tf = tm.rotation_consistency_filter(torch.from_numpy(feat_point),
                                        torch.from_numpy(point_angle),
                                        torch.from_numpy(feat_angle))
    assert np.array_equal(np.asarray(jf), tf.numpy())
