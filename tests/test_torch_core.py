"""Port parity: core/lie.py and core/camera.py against snakeslam_tpu.core.

The same float32 inputs, made with numpy from a seed, go through the JAX
function and its PyTorch counterpart; results agree to f32 atol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.core import camera as jcam
from snakeslam_tpu.core import lie as jlie
from snakeslam_tpu_torch.core import camera as tcam
from snakeslam_tpu_torch.core import lie as tlie

ATOL = 1e-5


def _tangents(seed, n=64):
    """SE3 tangents spanning the Taylor and the closed-form branches."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6))
    scale = np.concatenate([np.full(n // 4, 1e-3), np.full(n // 4, 0.03),
                            np.full(n // 4, 0.15), np.full(n - 3 * (n // 4),
                                                           1.0)])
    return (xi * scale[:, None]).astype(np.float32)


def _poses(seed, n=64):
    return np.array(jlie.se3_exp(jnp.asarray(_tangents(seed, n))),
                      dtype=np.float32)


def _close(a, b, atol=ATOL):
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().numpy().astype(np.float64) if torch.is_tensor(b) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= atol, f"max abs diff {err}"


@pytest.mark.parametrize("name", ["so3_exp", "hat"])
def test_so3_maps(name):
    w = _tangents(1)[:, 3:]
    _close(getattr(jlie, name)(jnp.asarray(w)),
           getattr(tlie, name)(torch.from_numpy(w)))


def test_se3_exp():
    xi = _tangents(2)
    _close(jlie.se3_exp(jnp.asarray(xi)), tlie.se3_exp(torch.from_numpy(xi)))


@pytest.mark.parametrize("name", ["se3_log", "se3_inverse", "orthonormalize",
                                  "rotmat_to_quat"])
def test_pose_maps(name):
    T = _poses(3)
    _close(getattr(jlie, name)(jnp.asarray(T)),
           getattr(tlie, name)(torch.from_numpy(T)))


def test_so3_log_and_quat_roundtrip():
    T = _poses(4)
    R = T[:, :3, :3]
    _close(jlie.so3_log(jnp.asarray(R)), tlie.so3_log(torch.from_numpy(R)))
    q = np.array(jlie.rotmat_to_quat(jnp.asarray(R)), dtype=np.float32)
    _close(jlie.quat_to_rotmat(jnp.asarray(q)),
           tlie.quat_to_rotmat(torch.from_numpy(q)))
    _close(jlie.quat_to_axis_angle(jnp.asarray(q)),
           tlie.quat_to_axis_angle(torch.from_numpy(q)))


def test_transform_points():
    rng = np.random.default_rng(5)
    T = _poses(5, 8)
    pts = rng.normal(size=(8, 32, 3)).astype(np.float32) * 5
    _close(jlie.transform_points(jnp.asarray(T), jnp.asarray(pts)),
           tlie.transform_points(torch.from_numpy(T), torch.from_numpy(pts)),
           atol=1e-4)


def _camera_inputs(seed):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(256, 3)).astype(np.float32) * [3, 2, 1]
    pc[:, 2] += 6.0
    pc[:4, 2] = [0.0, 1e-7, -2.0, 5e-7]   # the eps clamp on both sides
    return pc.astype(np.float32)


def test_project_and_stereo():
    pc = _camera_inputs(6)
    jc = jcam.Pinhole.create(458.654, 457.296, 367.215, 248.375)
    tc = tcam.Pinhole.create(458.654, 457.296, 367.215, 248.375)
    uv_j, z_j = jcam.project(jc, jnp.asarray(pc))
    uv_t, z_t = tcam.project(tc, torch.from_numpy(pc))
    ok = np.abs(pc[:, 2]) >= 1e-6
    _close(np.asarray(uv_j)[ok] / 1e3, uv_t[torch.from_numpy(ok)] / 1e3)
    _close(z_j, z_t)
    sj = jcam.StereoCamera(jc, jnp.float32(50.4))
    st = tcam.StereoCamera(tc, torch.tensor(50.4))
    uvr_j, _ = jcam.project_stereo(sj, jnp.asarray(pc))
    uvr_t, _ = tcam.project_stereo(st, torch.from_numpy(pc))
    _close(np.asarray(uvr_j)[ok] / 1e3, uvr_t[torch.from_numpy(ok)] / 1e3)


def test_unproject_and_pixels():
    rng = np.random.default_rng(7)
    uv = (rng.uniform(size=(128, 2)) * [752, 480]).astype(np.float32)
    z = rng.uniform(0.5, 30.0, size=128).astype(np.float32)
    jc = jcam.Pinhole.create(458.654, 457.296, 367.215, 248.375)
    tc = tcam.Pinhole.create(458.654, 457.296, 367.215, 248.375)
    _close(jcam.unproject(jc, jnp.asarray(uv), jnp.asarray(z)),
           tcam.unproject(tc, torch.from_numpy(uv), torch.from_numpy(z)),
           atol=1e-4)
    _close(jc.unproject_pixels(jnp.asarray(uv)),
           tc.unproject_pixels(torch.from_numpy(uv)))
    xn = rng.normal(size=(128, 2)).astype(np.float32) * 0.4
    _close(np.asarray(jc.project_normalized(jnp.asarray(xn))) / 1e3,
           tc.project_normalized(torch.from_numpy(xn)) / 1e3)


EUROC_DIST = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                  p2=1.76187114e-05)


def test_distort_and_undistort():
    """f32 parity with the JAX functions, and the f64 round trip of
    tests/test_camera.py (< 1e-8 after 10 Gauss-Newton steps)."""
    rng = np.random.default_rng(8)
    xn = rng.uniform(-0.6, 0.6, size=(512, 2))
    jd = jcam.Distortion.create(**EUROC_DIST)
    td = tcam.Distortion.create(**EUROC_DIST)
    x32 = xn.astype(np.float32)
    xd_j = jcam.distort(jnp.asarray(x32), jd)
    xd_t = tcam.distort(torch.from_numpy(x32), td)
    _close(xd_j, xd_t)
    xd32 = np.array(xd_j, dtype=np.float32)
    _close(jcam.undistort(jnp.asarray(xd32), jd),
           tcam.undistort(torch.from_numpy(xd32), td))
    d64 = tcam.Distortion.create(**EUROC_DIST, dtype=torch.float64)
    back = tcam.undistort(tcam.distort(torch.from_numpy(xn), d64), d64,
                          iters=10)
    assert np.abs(back.numpy() - xn).max() < 1e-8
    zero = tcam.Distortion.create()
    assert zero.is_zero() and not td.is_zero()
    assert torch.equal(tcam.distort(torch.from_numpy(x32), zero),
                       torch.from_numpy(x32))
