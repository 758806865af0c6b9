"""Port parity: the pixels-in stereo front-end.

The same rendered 320x240 stereo images (utils/render_world.py, seeded)
go through ``frontend/pixels.py`` of both packages on the CPU.

Tolerances:
  * ``stereo_frontend_batch``: valid feature counts within 1%; features
    matched by (octave, uv): >= 99% common; on the common ones >= 97% equal
    stereo-matched flags, and where both matched >= 97% of depths within
    rtol 1e-4.  The rest matched another right feature: the jitted JAX
    package rounds the BRIEF pre-blur through fused multiply-adds, so 1-2
    descriptor bits of a few percent of features differ
    (tests/test_torch_orb.py), which moves Hamming minima; measured on these
    frames: every feature common, flags 97.8-99.3% equal, depths 98.5-100%
    within rtol 1e-4;
  * the port's batched path against its own per-frame path
    (FeatureDetector + Preprocess): the same features and descriptors,
    uv within 1e-3 px, the same stereo matches, depths within rtol 1e-4 —
    as tests/test_pixels_frontend.py holds the JAX package.

The 48-frame pixels slice is held against the JAX package in
tests/test_torch_pixels_slice.py.
"""

import numpy as np
import pytest
import torch


def _world(SyntheticWorld, n_points, seed):
    return SyntheticWorld(n_points=n_points, seed=seed,
                          image_size=(320, 240), fx=260.0, fy=260.0,
                          cx=160.0, cy=120.0, baseline=0.12, extent=8.0)


def _settings(Settings, InputType):
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.width, s.height = 320, 240
    s.fx, s.fy, s.cx, s.cy = 260.0, 260.0, 160.0, 120.0
    s.bf = 260.0 * 0.12
    s.fd_features = 300
    s.fd_levels = 2
    return s


def _render(render_sequence, world, traj):
    L, R, ts, gt = [], [], [], []
    for t, T_cw, left, right in render_sequence(world, traj):
        L.append(left.astype(np.uint8))
        R.append(right.astype(np.uint8))
        ts.append(t)
        gt.append(T_cw)
    return np.stack(L), np.stack(R), ts, gt


@pytest.fixture(scope="module")
def frontend_frames():
    """Four rendered stereo pairs of tests/test_pixels_frontend.py's world
    (uint8, as the bench lane feeds them)."""
    from snakeslam_tpu_torch.utils.render_world import render_sequence
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    world = _world(SyntheticWorld, 400, 5)
    return _render(render_sequence, world,
                   orbit_trajectory(4, radius=6.5, arc=0.08, fps=20.0))


def test_render_world_matches_jax():
    from snakeslam_tpu.utils import render_world as J
    from snakeslam_tpu.utils.synthetic import SyntheticWorld as JW
    from snakeslam_tpu_torch.utils import render_world as T
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    traj = orbit_trajectory(2, radius=6.5, arc=0.08, fps=20.0)
    a = list(T.render_sequence(_world(SyntheticWorld, 300, 5), traj))
    b = list(J.render_sequence(_world(JW, 300, 5), traj))
    for (_, _, la, ra), (_, _, lb, rb) in zip(a, b):
        assert np.array_equal(la, lb) and np.array_equal(ra, rb)


def _jax_frontend(L, R, s_bf, n_features, levels):
    import jax.numpy as jnp
    from snakeslam_tpu.frontend.pixels import stereo_frontend_batch

    outs = stereo_frontend_batch(jnp.asarray(L), jnp.asarray(R),
                                 bf=s_bf, n_features=n_features,
                                 levels=levels, relaxed=True)
    return [np.asarray(a) for a in outs]


def _by_key(outs, b):
    uv, octave, _, packed, valid, right, depth = (a[b] for a in outs)
    m = np.asarray(valid, dtype=bool)
    return {(int(o), float(u), float(v)): (d.tobytes(), float(z))
            for o, (u, v), d, z in zip(octave[m], uv[m].astype(np.float32),
                                       packed[m], depth[m])}


def test_stereo_frontend_batch_matches_jax(frontend_frames):
    from snakeslam_tpu_torch.frontend.pixels import stereo_frontend_batch

    L, R, _, _ = frontend_frames
    bf = 260.0 * 0.12
    for n_features, levels in ((300, 2), (600, 4)):
        want = _jax_frontend(L, R, bf, n_features, levels)
        got = [a.numpy() for a in stereo_frontend_batch(
            torch.from_numpy(L), torch.from_numpy(R), bf=bf,
            n_features=n_features, levels=levels, relaxed=True)]
        assert got[3].dtype == np.uint8 and got[3].shape == (4, n_features, 32)
        for b in range(L.shape[0]):
            kt, kj = _by_key(got, b), _by_key(want, b)
            assert abs(len(kt) - len(kj)) <= 0.01 * len(kj), (len(kt), len(kj))
            common = [k for k in kt if k in kj]
            assert len(common) >= 0.99 * max(len(kt), len(kj))
            flags = np.array([(kt[k][1] > 0) == (kj[k][1] > 0)
                              for k in common])
            assert flags.mean() >= 0.97, flags.mean()
            both = [k for k in common if kt[k][1] > 0 and kj[k][1] > 0]
            assert len(both) >= 0.3 * len(common)
            close = np.isclose([kt[k][1] for k in both],
                               [kj[k][1] for k in both], rtol=1e-4, atol=0)
            assert close.mean() >= 0.97, close.mean()


def test_batched_path_matches_per_frame(frontend_frames):
    """As tests/test_pixels_frontend.py: the chunked front-end and the
    per-frame FeatureDetector + Preprocess give the same frames."""
    from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
    from snakeslam_tpu_torch.frontend.pixels import StereoPixelSource
    from snakeslam_tpu_torch.frontend.preprocess import Preprocess
    from snakeslam_tpu_torch.system.settings import InputType, Settings

    L, R, ts, _ = frontend_frames
    s = _settings(Settings, InputType)
    src = StereoPixelSource(s, "cpu")
    frames_b = src.materialize(src.dispatch(L, R), range(len(ts)), ts)
    det = FeatureDetector(s, device="cpu")
    pre = Preprocess(s, device="cpu")
    for i, (left, right) in enumerate(zip(L, R)):
        f = det.detect(left, i, ts[i])
        rf = det.detect(right, i + 10_000_000, ts[i])
        pre.stereo_match(f, rf)
        b = frames_b[i]
        assert b.n == f.n, f"frame {i}: {b.n} vs {f.n} features"
        assert np.allclose(b.uv, f.uv, atol=1e-3)
        assert np.array_equal(b.octave, f.octave)
        assert np.array_equal(b.descriptors, f.descriptors)
        assert np.array_equal(b.depth > 0, f.depth > 0)
        assert np.allclose(b.depth[b.depth > 0], f.depth[f.depth > 0],
                           rtol=1e-4)
        assert (b.depth > 0).sum() >= 0.3 * b.n


def test_feature_cache_stays_in_the_build_directory(frontend_frames,
                                                    tmp_path):
    """The disk cache round-trips under its cache directory, and building
    the native library writes nothing into the repository's native/."""
    from pathlib import Path

    from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.utils import native

    native_dir = Path(__file__).resolve().parent.parent / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native_dir.iterdir()}
    s = _settings(Settings, InputType)
    s.fd_buffer_to_file = True
    det = FeatureDetector(s, str(tmp_path / "features"), device="cpu")
    L = frontend_frames[0]
    f1 = det.detect(L[0], 7, 0.5)
    assert native.available()
    assert native._LIB_PATH.parent.name == "build"
    assert (tmp_path / "features" / "7.features").exists()
    f2 = det.detect(L[1], 7, 0.5)      # served from the cache, not L[1]
    assert np.array_equal(f2.uv, f1.uv)
    assert np.array_equal(f2.descriptors, f1.descriptors)
    assert np.array_equal(f2.angle, f1.angle)
    assert {p.name: p.stat().st_mtime_ns
            for p in native_dir.iterdir()} == before


def test_native_channel_roundtrip():
    from snakeslam_tpu_torch.utils import native

    ch = native.NativeChannel(capacity=2)
    assert ch.push({"a": 1}) and ch.push([1, 2, 3])
    assert ch.pop() == {"a": 1} and ch.pop() == [1, 2, 3]
    assert ch.pop(timeout_ms=50) is None


def test_undistort_keypoints():
    from snakeslam_tpu_torch.core.camera import Distortion
    from snakeslam_tpu_torch.frontend.preprocess import Preprocess
    from snakeslam_tpu_torch.map.slam_map import FrameData
    from snakeslam_tpu_torch.system.settings import InputType, Settings

    import jax.numpy as jnp
    from snakeslam_tpu.core.camera import Distortion as JD
    from snakeslam_tpu.frontend.preprocess import Preprocess as JP

    s = _settings(Settings, InputType)
    rng = np.random.default_rng(3)
    uv = rng.uniform([0, 0], [320, 240], size=(64, 2))
    coeffs = dict(k1=-0.28, k2=0.07, p1=2e-4, p2=2e-5)

    def frame():
        n = len(uv)
        return FrameData(frame_id=0, timestamp=0.0, uv=uv.copy(),
                         octave=np.zeros(n, np.int32),
                         angle=np.zeros(n, np.float32),
                         descriptors=np.zeros((n, 32), np.uint8),
                         right=np.full(n, -1.0), depth=np.full(n, -1.0))

    ft, fj = frame(), frame()
    Preprocess(s, Distortion.create(**coeffs), device="cpu") \
        .undistort_keypoints(ft)
    JP(s, JD.create(**coeffs, dtype=jnp.float32)).undistort_keypoints(fj)
    assert np.abs(ft.uv - uv).max() > 1.0
    np.testing.assert_allclose(ft.uv, fj.uv, atol=1e-3)


def test_pixel_sequence_indexing(frontend_frames):
    from snakeslam_tpu_torch.frontend.pixels import PixelFrameSequence
    from snakeslam_tpu_torch.system.settings import InputType, Settings

    L, R, ts, gt = frontend_frames
    seq = PixelFrameSequence(_settings(Settings, InputType), L, R, ts, gt,
                             chunk=3, device="cpu")
    assert len(seq) == 4
    assert [f.frame_id for f in seq[1:4]] == [1, 2, 3]
    assert seq[-1] is seq[3] and seq[0].gt_pose_cw is gt[0]
    with pytest.raises(IndexError):
        seq[4]
