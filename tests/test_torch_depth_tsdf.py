"""The port's RGB-D depth filter and TSDF fusion against the JAX package's.

``process_depth`` on noisy two-plane depth with flying pixels and sensor
holes, Gaussian radius 0 and 2 and two hysteresis settings: the kept
pixels identical and depths within 1e-5 (relative) of the jitted JAX
filter; the JAX tests' three behaviours (flying pixels cleared, noise
halved with the edge kept sharp, holes stay holes) hold for the port.
``integrate`` at V = 32 over two poses of a noisy plane with holes, then
``extract_surface_points``: TSDF within 1e-5, weights equal, the same point
set; and tests/test_tsdf.py's plane reconstruction.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.core import lie as jlie
from snakeslam_tpu.frontend import depth_processor as JDP
from snakeslam_tpu.ops import tsdf as JT
from snakeslam_tpu_torch.frontend import depth_processor as TDP
from snakeslam_tpu_torch.ops import tsdf as TT


def _scene(H=64, W=96, z_near=2.0, z_far=4.0):
    """Two fronto-parallel planes with a sharp depth edge at W//2."""
    depth = np.full((H, W), z_near, dtype=np.float32)
    depth[:, W // 2:] = z_far
    return depth


def _noisy(seed=0):
    rng = np.random.default_rng(seed)
    d = _scene()
    d += rng.normal(scale=0.03, size=d.shape).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0                       # holes
    fly = rng.random(d.shape) < 0.03
    d[fly] = rng.uniform(0.5, 9.0, int(fly.sum())).astype(np.float32)
    return d


@pytest.mark.parametrize("radius,hyst", [(0, (7.0, 9.0, 4)),
                                         (2, (7.0, 9.0, 4)),
                                         (2, (3.0, 12.0, 2))])
def test_process_depth_matches_jax(radius, hyst):
    hmin, hmax, iters = hyst
    for seed in (0, 1):
        d = _noisy(seed)
        j = np.asarray(JDP.process_depth(
            jnp.asarray(d), jnp.float32(50.0), gauss_radius=radius,
            hyst_min=hmin, hyst_max=hmax, hyst_iters=iters))
        t = TDP.process_depth(torch.from_numpy(d), 50.0, gauss_radius=radius,
                              hyst_min=hmin, hyst_max=hmax,
                              hyst_iters=iters).numpy()
        assert t.dtype == np.float32 and t.shape == d.shape
        np.testing.assert_array_equal(t > 0, j > 0)
        assert 0.5 < (t > 0).mean() < 0.98   # the filter does reject
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


def test_depth_processor_wrapper_matches_jax():
    d = _noisy(2).astype(np.float64)
    j = JDP.DepthProcessor(fx=500.0, bf=50.0, gauss_radius=2).process(d)
    t = TDP.DepthProcessor(fx=500.0, bf=50.0, gauss_radius=2,
                           device="cpu").process(d)
    np.testing.assert_array_equal(t > 0, j > 0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


def test_flying_pixels_removed():
    rng = np.random.default_rng(0)
    depth = _scene()
    ys = np.arange(6, 58, 8) + rng.integers(0, 3, size=7)
    xs = np.arange(6, 38, 5)[:7] + rng.integers(0, 2, size=7)
    depth[ys, xs] = 10.0
    out = TDP.DepthProcessor(fx=500.0, bf=50.0, device="cpu").process(depth)
    assert np.all(out[ys, xs] == 0.0)
    assert (out > 0).mean() > 0.9


def test_smoothing_reduces_noise_preserves_edge():
    rng = np.random.default_rng(1)
    noisy = _scene() + rng.normal(scale=0.02, size=(64, 96)).astype(
        np.float32)
    out = TDP.DepthProcessor(fx=500.0, bf=50.0, gauss_radius=2,
                             device="cpu").process(noisy)
    interior = (slice(8, 56), slice(8, 40))
    in_rms = np.sqrt(np.mean((noisy[interior] - 2.0) ** 2))
    out_rms = np.sqrt(np.mean((out[interior] - 2.0) ** 2))
    assert out_rms < 0.5 * in_rms
    mid = out[8:56, 40:56]
    assert ((mid > 2.3) & (mid < 3.7)).mean() < 0.02


def test_invalid_input_stays_invalid():
    depth = _scene()
    depth[10:20, 10:20] = 0.0
    out = TDP.DepthProcessor(fx=500.0, bf=50.0, device="cpu").process(depth)
    assert np.all(out[10:20, 10:20] == 0.0)


def _plane_depth(seed=3, H=120, W=160):
    rng = np.random.default_rng(seed)
    dep = (np.full((H, W), 2.0) + rng.normal(scale=0.01, size=(H, W))
           ).astype(np.float32)
    dep[rng.random(dep.shape) < 0.05] = 0.0
    return dep


def _poses():
    return [np.eye(4), np.array(jlie.se3_exp(jnp.asarray(
        [0.05, 0.0, 0.0, 0.0, 0.02, 0.0], dtype=jnp.float64)))]


@pytest.mark.parametrize("max_weight", [64.0, 1.0])
def test_tsdf_matches_jax(max_weight):
    H, W = 120, 160
    dep = _plane_depth()
    jv = JT.create_volume(resolution=32, extent=3.0, origin=(-1.5, -1.5, 0.0))
    tv = TT.create_volume(resolution=32, extent=3.0, origin=(-1.5, -1.5, 0.0),
                          device="cpu")
    for T_cw in _poses():
        jv = JT.integrate(jv, jnp.asarray(dep),
                          jnp.asarray(T_cw, dtype=jnp.float32),
                          jnp.float32(100.0), jnp.float32(100.0),
                          jnp.float32(W / 2), jnp.float32(H / 2),
                          jnp.float32(0.1), max_weight=max_weight)
        tv = TT.integrate(tv, torch.from_numpy(dep), torch.as_tensor(T_cw),
                          100.0, 100.0, W / 2, H / 2, 0.1,
                          max_weight=max_weight)
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    assert (tv.weight.numpy() > 0).mean() > 0.05
    for band in (0.25, 0.5):
        pj = JT.extract_surface_points(jv, iso_band=band)
        pt = TT.extract_surface_points(tv, iso_band=band)
        assert len(pt) == len(pj) > 100
        np.testing.assert_array_equal(pt, pj)


def test_tsdf_plane_reconstruction():
    """tests/test_tsdf.py's scene: a plane at z = 2 fused from two poses
    reconstructs at z ~ 2 within a voxel."""
    vol = TT.create_volume(resolution=96, extent=3.0, origin=(-1.5, -1.5, 0.0),
                           device="cpu")
    depth = torch.full((120, 160), 2.0)
    for T_cw in _poses():
        vol = TT.integrate(vol, depth, torch.as_tensor(T_cw), 100.0, 100.0,
                           80.0, 60.0, 0.1)
    pts = TT.extract_surface_points(vol, iso_band=0.3)
    assert len(pts) > 200
    assert abs(np.median(pts[:, 2]) - 2.0) < 0.1
    assert np.percentile(pts[:, 2], 95) - np.percentile(pts[:, 2], 5) < 0.25
