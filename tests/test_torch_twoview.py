"""Two-view reconstruction: the port against the JAX package.

Eigenvector and singular-vector signs differ between the libraries, so
matrices are compared up to sign and results by what they mean.

Tolerances (float64 unless said): ``_eight_point`` (plain, weighted,
batched) and ``_dlt_homography`` equal up to sign within 1e-8 after
normalization; ``decompose_essential``: the same four poses as a set within
1e-8; on the same key, with no hook, ``essential_ransac`` and
``homography_ransac`` draw exactly the JAX functions' sample indices
(``core/prng.py``; the tests run JAX with x64 on, so both draw float64),
pick the same best hypothesis (float64) and agree on >= 99.5% of the inlier flags
with counts within 0.5%, in float64 and in float32, on
tests/test_twoview.py's general (30% outliers) and planar scenes, and the
polished E gives the same epipolar distances on the inliers (1e-9 in
float64; 8e-6 against the 2e-5 gate in float32, where the 9x9 eigenvector
itself is only determined to ~1e-3);
``recover_pose_from_essential`` on the same E: pose within 1e-5, points
within 1e-4 of their norm, ``good`` identical; with each package's own
draws the recovered pose is within 2e-2 of the ground truth in both (the
linear 8-point bound of tests/test_twoview.py) and within 1e-3 of each
other; ``prng.sample_without_replacement`` draws distinct valid indices,
reproducibly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_twoview import _two_view_scene

from snakeslam_tpu.ops import twoview as JT
from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.ops import twoview as TT


@pytest.fixture(autouse=True)
def _draw_as_jax_x64():
    """The JAX package draws float64 under the tests' ``jax_enable_x64``."""
    with prng.x64(True):
        yield


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _j(a, dtype=jnp.float64):
    return jnp.asarray(np.asarray(a), dtype=dtype)


def _unit_up_to_sign(A):
    A = np.asarray(A, dtype=np.float64)
    A = A / np.linalg.norm(A, axis=(-2, -1), keepdims=True)
    flat = A.reshape(A.shape[:-2] + (9,))
    k = np.argmax(np.abs(flat), axis=-1)
    sgn = np.sign(np.take_along_axis(flat, k[..., None], -1))[..., None]
    return A * sgn


def _jax_samples(key, mask, n_hypotheses, size):
    """The draw of the JAX RANSACs (twoview.py:113-117, :213-217), in the
    default float of the running JAX configuration."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(
        key, (n_hypotheses, len(mask)), minval=1e-9, maxval=1.0)))
    _, idx = jax.lax.top_k(logits[None, :] + gumbel, size)
    return np.asarray(idx)


def test_eight_point_and_dlt_up_to_sign(rng):
    pts, T1, T2, xn1, xn2, _ = _two_view_scene(rng, noise=5e-4)
    # plain, weighted, and a batch of 8-samples
    np.testing.assert_allclose(
        _unit_up_to_sign(TT._eight_point(_t(xn1), _t(xn2)).numpy()),
        _unit_up_to_sign(JT._eight_point(_j(xn1), _j(xn2))), atol=1e-8)
    w = (rng.uniform(size=len(pts)) < 0.7).astype(np.float64)
    np.testing.assert_allclose(
        _unit_up_to_sign(TT._eight_point(_t(xn1), _t(xn2), _t(w)).numpy()),
        _unit_up_to_sign(JT._eight_point(_j(xn1), _j(xn2), _j(w))),
        atol=1e-8)
    idx = np.stack([rng.choice(len(pts), 8, replace=False)
                    for _ in range(32)])
    Et = TT._eight_point(_t(xn1)[idx], _t(xn2)[idx]).numpy()
    Ej = jax.vmap(lambda i: JT._eight_point(_j(xn1)[i], _j(xn2)[i]))(idx)
    np.testing.assert_allclose(_unit_up_to_sign(Et), _unit_up_to_sign(Ej),
                               atol=1e-7)
    idx4 = idx[:, :4]
    Ht = TT._dlt_homography(_t(xn1)[idx4], _t(xn2)[idx4]).numpy()
    Hj = jax.vmap(lambda i: JT._dlt_homography(_j(xn1)[i], _j(xn2)[i]))(idx4)
    np.testing.assert_allclose(_unit_up_to_sign(Ht), _unit_up_to_sign(Hj),
                               atol=1e-7)


def test_decompose_essential_same_candidates(rng):
    pts, T1, T2, xn1, xn2, _ = _two_view_scene(rng)
    E = np.asarray(JT._eight_point(_j(xn1), _j(xn2)))
    ct = TT.decompose_essential(_t(E)).numpy()
    cj = np.asarray(JT.decompose_essential(_j(E)))
    assert ct.shape == cj.shape == (4, 4, 4)
    for c in ct:
        assert min(np.abs(c - d).max() for d in cj) < 1e-8
        assert abs(np.linalg.det(c[:3, :3]) - 1.0) < 1e-9


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_essential_ransac_shared_samples(rng, dtype):
    pts, T1, T2, xn1, xn2, outliers = _two_view_scene(
        rng, outlier_frac=0.3, noise=5e-4)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    mask = np.ones(len(pts), dtype=bool)
    mask[-20:] = False                       # a padded tail
    key = jax.random.PRNGKey(1)
    Ej, inl_j, n_j = JT.essential_ransac(
        _j(xn1, jd), _j(xn2, jd), jnp.asarray(mask), key, n_hypotheses=256,
        threshold=2e-5)
    # the port's own draw on the same key: no hook
    Et, inl_t, n_t = TT.essential_ransac(
        _t(xn1, td), _t(xn2, td), torch.as_tensor(mask), np.asarray(key),
        n_hypotheses=256, threshold=2e-5)
    idx = _jax_samples(key, mask, 256, 8)
    np.testing.assert_array_equal(prng.sample_without_replacement(
        np.asarray(key), torch.as_tensor(mask), 256, 8).numpy(), idx)
    if dtype == "float64":
        # the same best hypothesis before the polish (in float32 the two
        # libraries' 8-point eigenvectors, and so the scores, differ)
        d2_t = TT.epipolar_distance_squared(
            TT._eight_point(_t(xn1)[idx], _t(xn2)[idx]), _t(xn1)[None],
            _t(xn2)[None])
        d2_j = jax.vmap(lambda E: JT.epipolar_distance_squared(
            E, _j(xn1), _j(xn2)))(jax.vmap(
                lambda i: JT._eight_point(_j(xn1)[i], _j(xn2)[i]))(idx))
        assert int(torch.argmax(((d2_t < 2e-5) & torch.as_tensor(mask))
                                .sum(1))) == \
            int(jnp.argmax(((d2_j < 2e-5) & jnp.asarray(mask)).sum(1)))
    inl_j, inl_t = np.asarray(inl_j), inl_t.numpy()
    assert (inl_j == inl_t).mean() >= 0.995
    assert abs(int(n_t) - int(n_j)) <= max(1, 0.005 * int(n_j))
    assert int(n_t) > 150 and inl_t[outliers].mean() < 0.1
    assert not inl_t[~mask].any()
    # the polished E means the same: epipolar distances agree
    d_t = TT.epipolar_distance_squared(_t(Et), _t(xn1), _t(xn2)).numpy()
    d_j = TT.epipolar_distance_squared(_t(np.asarray(Ej)), _t(xn1),
                                       _t(xn2)).numpy()
    # float32: the 9x9 normal matrix's smallest eigenvector is only
    # determined to ~1e-3 relative, so the two libraries' E differ by that
    tol = 1e-9 if dtype == "float64" else 8e-6
    np.testing.assert_allclose(d_t[inl_t], d_j[inl_t], atol=tol)
    if dtype == "float64":
        np.testing.assert_allclose(_unit_up_to_sign(Et.numpy()),
                                   _unit_up_to_sign(Ej), atol=1e-7)


def test_recover_pose_same_essential(rng):
    pts, T1, T2, xn1, xn2, outliers = _two_view_scene(
        rng, outlier_frac=0.3, noise=5e-4)
    mask = jnp.ones(len(pts), dtype=bool)
    E, inl, _ = JT.essential_ransac(_j(xn1), _j(xn2), mask,
                                    jax.random.PRNGKey(1), threshold=2e-5)
    T2j, Xj, gj = JT.recover_pose_from_essential(E, _j(xn1), _j(xn2), inl)
    # the port gets -E: the sign must not matter
    T2t, Xt, gt = TT.recover_pose_from_essential(
        _t(-np.asarray(E)), _t(xn1), _t(xn2), torch.as_tensor(np.asarray(inl)))
    np.testing.assert_allclose(T2t.numpy(), np.asarray(T2j), atol=1e-5)
    gj = np.asarray(gj)
    np.testing.assert_array_equal(gt.numpy(), gj)
    Xj, Xt = np.asarray(Xj), Xt.numpy()
    err = np.linalg.norm(Xt[gj] - Xj[gj], axis=1) / np.linalg.norm(Xj[gj],
                                                                   axis=1)
    assert err.max() < 1e-4


def test_own_draws_recover_ground_truth(rng):
    pts, T1, T2, xn1, xn2, outliers = _two_view_scene(
        rng, outlier_frac=0.3, noise=5e-4)
    mask = np.ones(len(pts), dtype=bool)
    Et, inl_t, n_t = TT.essential_ransac(
        _t(xn1), _t(xn2), torch.as_tensor(mask), prng.PRNGKey(7),
        n_hypotheses=512, threshold=2e-5)
    T2t, _, good_t = TT.recover_pose_from_essential(Et, _t(xn1), _t(xn2),
                                                    inl_t)
    Ej, inl_j, n_j = JT.essential_ransac(
        _j(xn1), _j(xn2), jnp.asarray(mask), jax.random.PRNGKey(1),
        n_hypotheses=512, threshold=2e-5)
    T2j, _, _ = JT.recover_pose_from_essential(Ej, _j(xn1), _j(xn2), inl_j)
    t_true = T2[:3, 3] / np.linalg.norm(T2[:3, 3])
    for T in (T2t.numpy(), np.asarray(T2j)):
        assert np.abs(T[:3, 3] / np.linalg.norm(T[:3, 3]) - t_true).max() \
            < 2e-2
        assert np.abs(T[:3, :3] @ T2[:3, :3].T - np.eye(3)).max() < 2e-2
    # every clean hypothesis polishes to the same answer
    np.testing.assert_allclose(T2t.numpy(), np.asarray(T2j), atol=1e-3)
    assert int(n_t) > 150 and int(good_t.sum()) > 150


@pytest.mark.parametrize("planar", [True, False])
def test_homography_ransac_shared_samples(rng, planar):
    pts, T1, T2, xn1, xn2, _ = _two_view_scene(rng, planar=planar,
                                               noise=2e-4)
    mask = np.ones(len(pts), dtype=bool)
    key = jax.random.PRNGKey(2)
    Hj, inl_j, n_j = JT.homography_ransac(_j(xn1), _j(xn2),
                                          jnp.asarray(mask), key)
    # the port's own draw on the same key: no hook
    Ht, inl_t, n_t = TT.homography_ransac(
        _t(xn1), _t(xn2), torch.as_tensor(mask), np.asarray(key))
    idx = _jax_samples(key, mask, 128, 4)
    np.testing.assert_array_equal(prng.sample_without_replacement(
        np.asarray(key), torch.as_tensor(mask), 128, 4).numpy(), idx)
    assert (np.asarray(inl_j) == inl_t.numpy()).mean() >= 0.995
    assert abs(int(n_t) - int(n_j)) <= max(1, 0.005 * int(n_j))
    np.testing.assert_allclose(_unit_up_to_sign(Ht.numpy()),
                               _unit_up_to_sign(Hj), atol=1e-6)
    if planar:
        assert int(n_t) > 0.8 * len(pts)
    else:
        assert int(n_t) < 0.5 * len(pts)


def test_draw_samples_distinct_valid_reproducible():
    mask = torch.zeros(64, dtype=torch.bool)
    mask[5:40] = True
    draw = prng.sample_without_replacement
    a = draw(prng.PRNGKey(3), mask, 100, 8)
    b = draw(prng.PRNGKey(3), mask, 100, 8)
    assert torch.equal(a, b) and a.shape == (100, 8)
    assert bool(mask[a].all())
    assert all(len(set(r.tolist())) == 8 for r in a)
    c = draw(prng.PRNGKey(4), mask, 100, 8)
    assert not torch.equal(a, c)
