"""BoW vocabulary, keyframe database, loop verification and relocalization:
the port against the JAX package on the same inputs.

The shared map is the ring of ``snakeslam_tpu_torch/utils/loop_problems.py``:
20 stereo keyframes looking outward from a circle of radius 7 m (a
60000-point synthetic world, seed 31), ~20 degrees apart and one step past
a full turn, so the last keyframes revisit the first ones; map points at
ground truth.  Its arrays are copied into each package's ``SlamMap``
(tests/test_torch_fusion.py's ``_copy_map``).

Tolerances: the vocabulary file byte-identical; BoW words identical,
vectors within 1e-12 (host, float64) and 1e-6 (torch, float32); database
ids identical and scores within 1e-6; packed knn2 matches identical; the
verification re-search's assignment identical, its refined pose within
2e-4, its inlier count within max(3, 1%) and every gate's outcome equal;
relocalization the same candidate and poses within 5 mm of each other.
"""

import copy
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fusion import _copy_map, _port_settings

from snakeslam_tpu.map.slam_map import FrameData as JFrame
from snakeslam_tpu.map.slam_map import SlamMap as JMap
from snakeslam_tpu_torch.map.slam_map import FrameData as TFrame
from snakeslam_tpu_torch.map.slam_map import SlamMap as TMap
from snakeslam_tpu_torch.utils import loop_problems as LP

REPO = Path(__file__).resolve().parent.parent


def _jax_settings(ts):
    """The JAX package's Settings with the fields of the port's ``ts``."""
    from snakeslam_tpu.system.settings import Settings

    js = Settings()
    for k, v in vars(ts).items():
        setattr(js, k, v)
    return js


def build_ring():
    """The ring of ``utils/loop_problems.build_ring``, its map copied into
    the JAX package's SlamMap: (JAX map, JAX settings, world, {world point
    id: map point})."""
    tmap, ts, world, pid_to_pt = LP.build_ring()
    return _copy_map(tmap, JMap), _jax_settings(ts), world, pid_to_pt


@pytest.fixture(scope="module")
def ring():
    return build_ring()


def _databases(jmap, tmap):
    from snakeslam_tpu.loop.keyframe_database import KeyframeDatabase as JDB
    from snakeslam_tpu.ops import bow as JBOW
    from snakeslam_tpu_torch.loop.keyframe_database import \
        KeyframeDatabase as TDB
    from snakeslam_tpu_torch.ops import bow as TBOW

    jvoc = JBOW.load_vocabulary_cached(
        REPO / "snakeslam_tpu" / "data" / "orbvoc_synth.npz")
    tvoc = TBOW.load_vocabulary_cached(
        REPO / "snakeslam_tpu_torch" / "data" / "orbvoc_synth.npz")
    jdb, tdb = JDB(jvoc, jmap), TDB(tvoc, tmap)
    for k in jmap.valid_keyframes():
        jdb.add(int(k))
        tdb.add(int(k))
    return jdb, tdb


# ---------------------------------------------------------------------------
# vocabulary and transforms
# ---------------------------------------------------------------------------

def test_vocabulary_copy_is_byte_identical():
    a = REPO / "snakeslam_tpu" / "data" / "orbvoc_synth.npz"
    b = REPO / "snakeslam_tpu_torch" / "data" / "orbvoc_synth.npz"
    assert b.stat().st_size == a.stat().st_size == 367966
    assert filecmp.cmp(a, b, shallow=False)


def test_transforms_match_jax(rng):
    import jax.numpy as jnp

    from snakeslam_tpu.ops import bow as JBOW
    from snakeslam_tpu_torch.ops import bow as TBOW

    jvoc = JBOW.load_vocabulary(
        REPO / "snakeslam_tpu" / "data" / "orbvoc_synth.npz")
    tvoc = TBOW.load_vocabulary(
        REPO / "snakeslam_tpu_torch" / "data" / "orbvoc_synth.npz")
    bits = rng.integers(0, 2, size=(400, 256)).astype(np.int8)
    packed = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    valid = rng.random(400) < 0.9
    for args in ((packed,), (packed, valid)):
        wj, vj = JBOW.transform_packed_np(jvoc, *args)
        wt, vt = TBOW.transform_packed_np(tvoc, *args)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_allclose(vt, vj, atol=1e-12)
    wj, vj = JBOW.transform_np(jvoc, bits, valid)
    wt, vt = TBOW.transform_np(tvoc, bits, valid)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(vt, vj, atol=1e-12)
    wj, vj = JBOW.transform(jvoc, jnp.asarray(bits), jnp.asarray(valid))
    wt, vt = TBOW.transform(tvoc, torch.from_numpy(bits),
                            torch.from_numpy(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    # the torch transform agrees with the host descent the database uses
    np.testing.assert_array_equal(wt.numpy(), TBOW.transform_np(tvoc, bits)[0])
    other = TBOW.transform(tvoc, torch.from_numpy(bits[::-1].copy()),
                           torch.ones(400, dtype=torch.bool))[1]
    sj = JBOW.score_l1(vj, jnp.stack([vj, jnp.asarray(other.numpy())]))
    st = TBOW.score_l1(vt, torch.stack([vt, other]))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


def test_trained_vocabulary_matches_jax(rng):
    from snakeslam_tpu.ops import bow as JBOW
    from snakeslam_tpu_torch.ops import bow as TBOW

    train = rng.integers(0, 2, size=(2000, 256)).astype(np.int8)
    jv = JBOW.train_vocabulary(train, k=6, levels=3, seed=2)
    tv = TBOW.train_vocabulary(train, k=6, levels=3, seed=2)
    np.testing.assert_array_equal(tv.node_bits, np.asarray(jv.node_bits))
    np.testing.assert_array_equal(tv.idf, np.asarray(jv.idf))


# ---------------------------------------------------------------------------
# keyframe database and matching on the ring
# ---------------------------------------------------------------------------

def test_keyframe_database_matches_jax(ring):
    jmap, _, world, _ = ring
    tmap = _copy_map(jmap, TMap)
    jdb, tdb = _databases(jmap, tmap)
    np.testing.assert_array_equal(tdb.vectors, jdb.vectors)
    assert tdb.words.keys() == jdb.words.keys()
    n_loop = 0
    for kf in [int(k) for k in jmap.valid_keyframes()]:
        ij, sj = jdb.query(jdb.vectors[kf], words=jdb.words[kf],
                           exclude={kf}, min_score=0.0, top_n=5)
        it, st = tdb.query(tdb.vectors[kf], words=tdb.words[kf],
                           exclude={kf}, min_score=0.0, top_n=5)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(st, sj, atol=1e-6)
        ij, sj = jdb.detect_loop_candidates(kf, min_score=0.0, top_n=5)
        it, st = tdb.detect_loop_candidates(kf, min_score=0.0, top_n=5)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(st, sj, atol=1e-6)
        n_loop += len(it)
    assert n_loop > 0, "the ring must produce loop candidates"
    # a fresh view near keyframe 2 retrieves it for relocalization
    sf = world.observe(LP.ring_pose(2.1 * LP.RING_STEP), max_features=620,
                       noise_px=0.2, n_clutter=20, with_stereo=True)
    bits = np.unpackbits(sf.descriptors, axis=-1, bitorder="little")
    ij, sj = jdb.detect_relocalization_candidates(bits, top_n=3)
    it, st = tdb.detect_relocalization_candidates(bits, top_n=3)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-6)
    assert 2 in set(int(i) for i in it)


def test_knn2_packed_matches_jax(ring, rng):
    from snakeslam_tpu.ops import matching as JM
    from snakeslam_tpu_torch.ops import matching as TM

    jmap, _, _, _ = ring
    a = jmap.kf_feat_desc[2, :jmap.kf_n_feat[2]]
    b = jmap.kf_feat_desc[3, :jmap.kf_n_feat[3]]
    for args, kw in (((a, b), dict(ratio=0.75, max_dist=50)),
                     ((a, b), dict(cross_check=False)),
                     ((a[:1], b), {}), ((a, b[:1]), {}), ((a[:0], b), {})):
        ij, dj = JM.knn2_ratio_match_packed_np(*args, **kw)
        it, dt = TM.knn2_ratio_match_packed_np(*args, **kw)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)
    ij, _ = JM.knn2_ratio_match_packed_np(a, b, ratio=0.75, max_dist=50)
    assert (ij >= 0).sum() > 100


# ---------------------------------------------------------------------------
# Sim3 verification on the revisit geometry of test_loop_verification.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def revisit():
    from test_loop_verification import _build_revisit_map

    from snakeslam_tpu_torch.loop.keyframe_database import KeyframeDatabase
    from snakeslam_tpu_torch.loop.loop_closing import LoopClosing
    from snakeslam_tpu_torch.ops import bow as TBOW

    jlc, jmap, kf, cand = _build_revisit_map()
    tmap = _copy_map(jmap, TMap)
    ts = _port_settings(jlc.s)
    voc = TBOW.load_vocabulary_cached(
        REPO / "snakeslam_tpu_torch" / "data" / "orbvoc_synth.npz")
    tlc = LoopClosing(ts, tmap, KeyframeDatabase(voc, tmap), "cpu")
    return jlc, tlc, kf, cand


def test_verify_search_refine_matches_jax(revisit):
    """The gates' inputs: the guided re-search and the 3 x 3 pose refine."""
    import jax.numpy as jnp

    from snakeslam_tpu.loop import loop_closing as JLC
    from snakeslam_tpu.map.slam_map import transform_pose_cw
    from snakeslam_tpu.tracking import staging as JST
    from snakeslam_tpu_torch.loop import loop_closing as TLC
    from snakeslam_tpu_torch.tracking import staging as TST

    jlc, tlc, kf, cand = revisit
    jm, tm = jlc.map, tlc.map
    for R, t in ((np.eye(3), np.zeros(3)),
                 (TLC.lie.so3_exp(torch.tensor([0.0, 0.01, 0.0],
                                               dtype=torch.float64)).numpy(),
                  np.array([0.05, 0.0, -0.03]))):
        T0 = transform_pose_cw(jm.kf_pose[kf], 1.0, R, t).astype(np.float32)
        pts = jm.keyframe_points(cand)
        jlm, _ = JST.snapshot_points(jm, pts, 1024)
        tlm, _ = TST.snapshot_points(tm, pts, 1024, "cpu")
        jfeat = JST.kf_features_cached(jm, kf, 512)
        tfeat = TST.kf_features_cached(tm, kf, 512, "cpu")
        jo = [np.asarray(x) for x in JLC._verify_search_refine(
            jlm, jfeat, jnp.asarray(T0), jlc.cam, jlc.bf, jlc.bounds,
            jlc.st)]
        to = [x.numpy() for x in TLC._verify_search_refine(
            tlm, tfeat, torch.from_numpy(T0), tlc.cam, tlc.bf, tlc.bounds,
            tlc.st)]
        np.testing.assert_array_equal(to[1], jo[1])            # assign
        assert (to[1] >= 0).sum() > 100
        np.testing.assert_allclose(to[0], jo[0], atol=2e-4)    # pose
        nj, nt = int(jo[3]), int(to[3])
        assert abs(nt - nj) <= max(3, nj // 100), (nt, nj)
        assert (to[2] == jo[2]).mean() > 0.99
        np.testing.assert_allclose(to[5], jo[5], rtol=1e-5)    # depth
        m = jo[1] >= 0
        np.testing.assert_allclose(to[4][m], jo[4][m], rtol=1e-4)


def test_verify_sim3_gates_match_jax(revisit):
    jlc, tlc, kf, cand = revisit
    pairs = (np.array([], dtype=int), np.array([], dtype=int))
    I3, z3 = np.eye(3), np.zeros(3)
    oj = jlc._verify_sim3(kf, cand, 1.0, I3, z3, pairs)
    ot = tlc._verify_sim3(kf, cand, 1.0, I3, z3, pairs)
    assert oj is not None and ot is not None
    assert abs(ot[0] - oj[0]) < 1e-9
    np.testing.assert_allclose(ot[1], oj[1], atol=2e-4)
    np.testing.assert_allclose(ot[2], oj[2], atol=2e-4)
    nj, nt = len(oj[3][0]), len(ot[3][0])
    assert abs(nt - nj) <= max(3, nj // 100), (nt, nj)
    assert nt >= 30
    th = np.deg2rad(25.0)
    R_bad = np.array([[np.cos(th), -np.sin(th), 0.0],
                      [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    t_bad = np.array([2.0, -1.0, 0.5])
    assert jlc._verify_sim3(kf, cand, 1.0, R_bad, t_bad, pairs) is None
    assert tlc._verify_sim3(kf, cand, 1.0, R_bad, t_bad, pairs) is None


# ---------------------------------------------------------------------------
# relocalization on the ring
# ---------------------------------------------------------------------------

def test_relocalizer_recovers_same_candidate(ring):
    from snakeslam_tpu.loop.relocalization import Relocalizer as JR
    from snakeslam_tpu_torch.loop.relocalization import Relocalizer as TR

    jmap, js, world, _ = ring
    tmap = _copy_map(jmap, TMap)
    jdb, tdb = _databases(jmap, tmap)
    sf = world.observe(LP.ring_pose(5.2 * LP.RING_STEP), max_features=620,
                       noise_px=0.2, n_clutter=20, with_stereo=True)
    jf = LP.frame_from(sf, 100, cls=JFrame)
    tf = LP.frame_from(copy.deepcopy(sf), 100, cls=TFrame)
    assert JR(js, jmap, jdb).try_relocalize(jf)
    assert TR(_port_settings(js), tmap, tdb, "cpu").try_relocalize(tf)
    assert tf.ref_kf == jf.ref_kf
    cj = np.linalg.inv(jf.pose_cw)[:3, 3]
    ct = np.linalg.inv(tf.pose_cw)[:3, 3]
    gt = np.linalg.inv(sf.pose_cw)[:3, 3]
    assert np.linalg.norm(ct - cj) < 5e-3
    assert np.linalg.norm(ct - gt) < 1e-2
    assert (tf.matches >= 0).sum() >= 30
