"""Triangulation ops: the port against the JAX package.

Inputs are made with numpy from a seed and go through both packages in
float32.  Tolerances: ``triangulate_homogeneous`` atol 1e-5 (points within
~10 m: 1e-5 is ~100 f32 ulps); the essential matrix and epipolar distances
rtol 1e-5; the depth grid exact; ``triangulate_pair`` integer outputs
(``valid``, ``match_b``, ``far_away``) identical and ``point`` within rtol
1e-4 (of the point's norm) on valid rows, on the setups of tests/test_triangulation_stereo.py and
tests/test_depth_grid.py and on a seeded three-keyframe scene, with and
without the depth grid.  The port's batched call (a leading pair dim) is
held against the JAX function called once per pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snakeslam_tpu.core import lie as JL
from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.core.pyramid import ScalePyramid
from snakeslam_tpu.ops import depth_grid as JDG
from snakeslam_tpu.ops import triangulate_pairs as JTP
from snakeslam_tpu.ops import triangulation as JTR
from snakeslam_tpu.ops import twoview as JTV
from snakeslam_tpu.ops.matching import FrameFeatures as JFF
from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.core.camera import Pinhole as TPinhole
from snakeslam_tpu_torch.ops import depth_grid as TDG
from snakeslam_tpu_torch.ops import triangulate_pairs as TTP
from snakeslam_tpu_torch.ops import triangulation as TTR
from snakeslam_tpu_torch.ops import twoview as TTV
from snakeslam_tpu_torch.ops.matching import FrameFeatures as TFF

FX = FY = 400.0
CX, CY = 376.0, 240.0
BF = 40.0
W, H = 752, 480
PYR = ScalePyramid.create(4, 1.2)


def _pose(rng, scale=1.0):
    xi = np.concatenate([rng.normal(size=3) * scale,
                         rng.normal(size=3) * 0.1 * scale])
    return np.asarray(JL.se3_exp(jnp.asarray(xi, dtype=jnp.float64)),
                      dtype=np.float32)


def test_triangulate_homogeneous_matches_jax():
    rng = np.random.default_rng(0)
    # keyframe-pair geometry: a 3 m baseline at 4-6 m depth, where the f32
    # closed form stays within ~3e-6 m of its float64 value in both
    # packages (narrow baselines make the 3x3 normal equations
    # ill-conditioned: at 1.5 m and 8 +- 2 m two f32 evaluation orders
    # differ by up to 4e-5 m)
    n = 500
    T1 = np.stack([_pose(rng, 0.05) for _ in range(n)])
    T2 = np.stack([_pose(rng, 0.05) for _ in range(n)])
    T2[:, 0, 3] -= 3.0
    X = rng.uniform(-1, 1, (n, 3)) + np.array([1.5, 0.0, 5.0])

    def xn(T):
        pc = np.einsum("nij,nj->ni", T[:, :3, :3], X) + T[:, :3, 3]
        return (pc[:, :2] / pc[:, 2:]).astype(np.float32)

    x1, x2 = xn(T1), xn(T2)
    j = np.asarray(JTR.triangulate_homogeneous(*map(jnp.asarray,
                                                    (T1, T2, x1, x2))))
    t = TTR.triangulate_homogeneous(*map(torch.from_numpy,
                                         (T1, T2, x1, x2))).numpy()
    f64 = np.asarray(JTR.triangulate_homogeneous(
        *(jnp.asarray(a.astype(np.float64)) for a in (T1, T2, x1, x2))))
    np.testing.assert_allclose(t, j, atol=1e-5)
    np.testing.assert_allclose(t, f64, atol=1e-5)
    np.testing.assert_allclose(t, X, atol=1e-2)
    Xf = X.astype(np.float32)
    jz = JTR.depths_in_cameras(jnp.asarray(T1[0]), jnp.asarray(T2[0]),
                               jnp.asarray(Xf))
    tz = TTR.depths_in_cameras(torch.from_numpy(T1[0]),
                               torch.from_numpy(T2[0]), torch.from_numpy(Xf))
    for a, b in zip(jz, tz):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
    je, jzz = JTR.reprojection_error_normalized(
        jnp.asarray(T1[0]), jnp.asarray(Xf), jnp.asarray(x1))
    te, tzz = TTR.reprojection_error_normalized(
        torch.from_numpy(T1[0]), torch.from_numpy(Xf), torch.from_numpy(x1))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-7)
    jp = JTR.parallax_cos(jnp.asarray(T1[0]), jnp.asarray(T2[0]),
                          jnp.asarray(Xf))
    tp = TTR.parallax_cos(torch.from_numpy(T1[0]), torch.from_numpy(T2[0]),
                          torch.from_numpy(Xf))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)


def test_essential_and_epipolar_distance_match_jax():
    rng = np.random.default_rng(1)
    T12 = np.stack([_pose(rng) for _ in range(16)])
    x1 = rng.normal(size=(16, 40, 2)).astype(np.float32) * 0.3
    x2 = rng.normal(size=(16, 40, 2)).astype(np.float32) * 0.3
    Ej = np.asarray(JTV.essential_matrix(jnp.asarray(T12)))
    Et = TTV.essential_matrix(torch.from_numpy(T12)).numpy()
    np.testing.assert_allclose(Et, Ej, rtol=1e-5, atol=1e-6)
    dj = np.asarray(JTV.epipolar_distance_squared(
        jnp.asarray(Ej)[:, None], jnp.asarray(x1), jnp.asarray(x2)))
    dt = TTV.epipolar_distance_squared(
        torch.from_numpy(Ej)[:, None], torch.from_numpy(x1),
        torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-9)
    # the RANSACs are ported (tests/test_torch_twoview.py holds them
    # against the JAX package): a call runs and masks what it is told to
    mask = torch.arange(40) < 30
    E, inl, n = TTV.essential_ransac(
        torch.from_numpy(x1[0]), torch.from_numpy(x2[0]), mask,
        prng.PRNGKey(0), n_hypotheses=8)
    assert E.shape == (3, 3) and int(n) == int(inl.sum())
    assert not bool(inl[30:].any())


def test_depth_grid_is_exact():
    rng = np.random.default_rng(2)
    for n in (0, 2, 40, 400):
        uv = rng.uniform((0, 0), (W, H), size=(n, 2))
        z = rng.uniform(-1.0, 10.0, size=n)
        np.testing.assert_array_equal(TDG.build_depth_grid(uv, z, W, H),
                                      JDG.build_depth_grid(uv, z, W, H))
    assert TDG.grid_shape(W, H) == JDG.grid_shape(W, H)


# ---------------------------------------------------------------------------
# triangulate_pair
# ---------------------------------------------------------------------------

def _consts():
    jc = dict(cam=JPinhole.create(FX, FY, CX, CY, dtype=jnp.float32),
              bf=jnp.float32(BF), scales=jnp.asarray(PYR.scales),
              inv_sigma2=jnp.asarray(PYR.inv_sigma2))
    tc = dict(cam=TPinhole.create(FX, FY, CX, CY),
              bf=torch.tensor(BF, dtype=torch.float32),
              scales=torch.from_numpy(PYR.scales),
              inv_sigma2=torch.from_numpy(PYR.inv_sigma2))
    return jc, tc


def _feats(uv, bits, right, octave, valid=None):
    n = len(uv)
    valid = np.ones(n, bool) if valid is None else valid
    arrs = (np.asarray(uv, np.float32), np.asarray(right, np.float32),
            np.asarray(octave, np.int32), np.zeros(n, np.float32),
            np.asarray(bits, np.int8), valid)
    return (JFF(*(jnp.asarray(a) for a in arrs)),
            TFF(*(torch.from_numpy(np.array(a)) for a in arrs)))


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                     FY * pc[:, 1] / pc[:, 2] + CY], axis=1), pc[:, 2]


def _stereo_setup(rng, pts_w, baseline_kf, depth_noise=0.0):
    """tests/test_triangulation_stereo.py's setup: two keyframes along x,
    both with stereo right points."""
    T_a = np.eye(4, dtype=np.float32)
    T_b = np.eye(4, dtype=np.float32)
    T_b[0, 3] = -baseline_kf
    n = len(pts_w)
    bits = rng.integers(0, 2, size=(n, 256))
    uv_a, za = _project(T_a, pts_w)
    uv_b, zb = _project(T_b, pts_w)
    fa = _feats(uv_a, bits, uv_a[:, 0] - BF / (za + depth_noise),
                np.zeros(n))
    fb = _feats(uv_b, bits, uv_b[:, 0] - BF / (zb + depth_noise),
                np.zeros(n))
    return fa, fb, T_a, T_b, None


def _depth_grid_setup(rng):
    """tests/test_depth_grid.py's repeated-texture setup."""
    T_a = np.eye(4, dtype=np.float32)
    T_b = np.eye(4, dtype=np.float32)
    T_b[0, 3] = -0.5
    X = np.array([[0.3, 0.1, 4.0], [1.1, 0.1, 4.0]])
    bits = np.repeat(rng.integers(0, 2, size=(1, 256)), 2, axis=0)
    uv_a, _ = _project(T_a, X)
    uv_b, _ = _project(T_b, X)
    fa = _feats(uv_a, bits, np.full(2, -1.0), np.zeros(2))
    fb = _feats(uv_b, bits, np.full(2, -1.0), np.zeros(2))
    grid = JDG.build_depth_grid(uv_a, np.array([4.0, 4.0]), W, H)
    return fa, fb, T_a, T_b, grid


def _scene_setup(rng, n_kf=4, n_pts=300, grid=True):
    """A seeded scene: keyframe a and n_kf - 1 neighbours on an arc around
    a point cloud, noisy keypoints, descriptors of the true point with a few
    bits flipped, 10% clutter features, mixed octaves, stereo on two
    thirds of the features; the pair list is neighbours b_1..b_k."""
    X = rng.uniform(-3, 3, (n_pts, 3)) + np.array([0.0, 0.0, 9.0])
    desc = rng.integers(0, 2, size=(n_pts, 256))
    poses = []
    for k in range(n_kf):
        T = np.eye(4)
        ang = 0.05 * k
        T[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                              [-np.sin(ang), 0, np.cos(ang)]])
        T[0, 3] = -0.4 * k
        poses.append(T.astype(np.float32))
    feats = []
    for k, T in enumerate(poses):
        order = rng.permutation(n_pts)
        uv, z = _project(T, X[order])
        uv = uv + rng.normal(scale=0.4, size=uv.shape)
        bits = desc[order].copy()
        flip = rng.random(bits.shape) < 0.03
        bits[flip] ^= 1
        n_clutter = n_pts // 10
        uv = np.concatenate([uv, rng.uniform((0, 0), (W, H), (n_clutter, 2))])
        bits = np.concatenate([bits, rng.integers(0, 2, (n_clutter, 256))])
        z = np.concatenate([z, rng.uniform(4, 12, n_clutter)])
        octave = rng.integers(0, 3, len(uv))
        right = np.where(rng.random(len(uv)) < 0.66,
                         uv[:, 0] - BF / z + rng.normal(scale=0.3,
                                                        size=len(uv)), -1.0)
        feats.append((uv, bits, right, octave))
    g = None
    if grid:
        uv0, z0 = feats[0][0], np.concatenate(
            [_project(poses[0], X)[1], np.zeros(n_pts // 10)])
        g = JDG.build_depth_grid(uv0[: n_pts], z0[: n_pts] * 0 + 9.0, W, H)
    return poses, feats, g


def _pair_kw(grid, th_depth, port):
    kw = dict(feature_distance=50, epipolar_distance=4.0, error_mono=2.1,
              bounds_wh=(float(W), float(H)), th_depth=th_depth)
    if grid is not None:
        kw["grid_a"] = (torch.from_numpy(grid.astype(np.float32)) if port
                        else jnp.asarray(grid, dtype=jnp.float32))
    return kw


def _check_pair(out_j, out_t):
    for k in ("valid", "match_b", "far_away"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]),
                                      err_msg=k)
    # rtol 1e-4 of each valid point's distance from the origin (a single
    # coordinate may sit near 0)
    v = np.asarray(out_j["valid"])
    pj = np.asarray(out_j["point"])[v]
    pt = out_t["point"].numpy()[v]
    err = np.linalg.norm(pt - pj, axis=1)
    assert (err <= 1e-4 * np.linalg.norm(pj, axis=1)).all(), err.max()
    assert int(out_t["n_new"]) == int(out_j["n_new"])


SETUPS = {
    "low_parallax_stereo": lambda rng: _stereo_setup(
        rng, np.array([[0.3, 0.1, 2.0], [-0.4, -0.2, 2.5], [0.1, 0.3, 3.0]]),
        0.002),
    "high_parallax_dlt": lambda rng: _stereo_setup(
        rng, np.array([[0.3, 0.1, 20.0], [-0.6, -0.2, 25.0]]), 4.0, 1.0),
    "far_away": lambda rng: _stereo_setup(
        rng, np.array([[0.3, 0.1, 2.0], [0.2, -0.3, 30.0]]), 0.002),
    "depth_grid": _depth_grid_setup,
}


@pytest.mark.parametrize("name", sorted(SETUPS))
@pytest.mark.parametrize("use_grid", [False, True])
def test_triangulate_pair_matches_jax_on_the_reference_setups(name,
                                                              use_grid):
    rng = np.random.default_rng(3)
    (fja, fta), (fjb, ftb), T_a, T_b, grid = SETUPS[name](rng)
    if not use_grid:
        grid = None
    elif grid is None:
        grid = JDG.build_depth_grid(np.asarray(fja.uv), np.full(
            fja.uv.shape[0], 5.0), W, H)
    jc, tc = _consts()
    n = fja.uv.shape[0]
    free_j, free_t = jnp.ones(n, bool), torch.ones(n, dtype=torch.bool)
    out_j = JTP.triangulate_pair(fja, fjb, free_j, free_j, jnp.asarray(T_a),
                                 jnp.asarray(T_b), **jc,
                                 **_pair_kw(grid, 20.0, False))
    out_t = TTP.triangulate_pair(fta, ftb, free_t, free_t,
                                 torch.from_numpy(T_a), torch.from_numpy(T_b),
                                 **tc, **_pair_kw(grid, 20.0, True))
    _check_pair(out_j, out_t)
    assert np.asarray(out_j["valid"]).any()


@pytest.mark.parametrize("use_grid", [False, True])
def test_triangulate_pairs_batch_matches_jax_per_pair(use_grid):
    """Keyframe a against three neighbours in one batched call, against the
    JAX function called once per pair; one neighbour has half its features
    taken (free_b False)."""
    rng = np.random.default_rng(4)
    poses, feats, grid = _scene_setup(rng, grid=use_grid)
    jc, tc = _consts()
    fa_j, fa_t = _feats(*feats[0])
    n = fa_t.uv.shape[0]
    free_a = rng.random(n) < 0.9
    free_b = np.ones((3, n), bool)
    free_b[1, ::2] = False
    ftb = [_feats(*f)[1] for f in feats[1:]]
    batch_b = TFF(*(torch.stack([getattr(f, k) for f in ftb])
                    for k in TFF._fields))
    out_t = TTP.triangulate_pairs_batch(
        fa_t, batch_b, torch.from_numpy(free_a), torch.from_numpy(free_b),
        torch.from_numpy(poses[0]), torch.from_numpy(np.stack(poses[1:])),
        **tc, **_pair_kw(grid, 25.0, True))
    n_valid = 0
    for b in range(3):
        fb_j, _ = _feats(*feats[b + 1])
        out_j = JTP.triangulate_pair(
            fa_j, fb_j, jnp.asarray(free_a), jnp.asarray(free_b[b]),
            jnp.asarray(poses[0]), jnp.asarray(poses[b + 1]), **jc,
            **_pair_kw(grid, 25.0, False))
        _check_pair(out_j, {k: v[b] for k, v in out_t.items()})
        n_valid += int(out_j["n_new"])
    assert n_valid > 100
