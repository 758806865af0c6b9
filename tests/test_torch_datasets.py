"""The port's dataset readers and Input against the JAX package's.

Each reader runs in both packages on the miniature on-disk fixtures of
tests/test_datasets.py (TUM-RGBD, EuRoC with IMU and sensor.yaml, KITTI
stereo with calib and poses, ScanNet with millimetre depth, ZJU in the
EuRoC layout): images, depths, timestamps, IMU windows, calibration and
ground truth must be equal, exactly.  ``Input`` takes the dataset's
calibration and distortion as the JAX one does, and paces playback.  The
rendered TUM lane's writer (``utils/tum_fixture.py``) writes PNGs the
reader decodes back to the rendered arrays.
"""

import numpy as np
import pytest
from PIL import Image

from snakeslam_tpu.frontend import datasets as JD
from snakeslam_tpu.frontend.input import Input as JInput
from snakeslam_tpu.system.settings import InputType as JInputType
from snakeslam_tpu.system.settings import SensorType as JSensorType
from snakeslam_tpu.system.settings import Settings as JSettings
from snakeslam_tpu_torch.frontend import datasets as TD
from snakeslam_tpu_torch.frontend.input import Input
from snakeslam_tpu_torch.system.settings import InputType, SensorType, Settings

W, H = 320, 240


def _texture(rng, size=1024):
    tex = np.full((size, size), 120.0)
    for _ in range(400):
        h, w = rng.integers(6, 30), rng.integers(6, 30)
        y, x = rng.integers(0, size - h), rng.integers(0, size - w)
        tex[y:y + h, x:x + w] = rng.choice([30, 80, 160, 230])
    return tex.astype(np.uint8)


def _tum(root, rng, n=4):
    tex = _texture(rng)
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb, dep, gt = [], [], []
    for i in range(n):
        t = 1305031102.175 + i * 0.1
        crop = tex[300:300 + H, 300 + 6 * i:300 + 6 * i + W]
        Image.fromarray(crop).save(root / "rgb" / f"{t:.6f}.png")
        depth = rng.integers(0, 30000, size=(H, W)).astype(np.uint16)
        # depth stamped 10 ms after the image: the reader associates them
        Image.fromarray(depth).save(root / "depth" / f"{t + 0.01:.6f}.png")
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png")
        gt.append(f"{t:.6f} {i * 0.02:.6f} 0.1 -0.2 0 0 0.0998 0.995")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb))
    (root / "depth.txt").write_text("\n".join(dep))
    (root / "groundtruth.txt").write_text("\n".join(gt))


def _euroc(root, rng, stereo=True, yaml_distortion=True):
    mav = root / "mav0"
    img = _texture(rng)[:H, :W]
    for cam in ("cam0", "cam1") if stereo else ("cam0",):
        (mav / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(3):
            ts_ns = 1403636579763555584 + i * 50_000_000
            Image.fromarray(np.roll(img, i, axis=1)).save(
                mav / cam / "data" / f"{ts_ns}.png")
            lines.append(f"{ts_ns},{ts_ns}.png")
        (mav / cam / "data.csv").write_text("\n".join(lines))
    yaml = ("intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
            "resolution: [320, 240]\n")
    if yaml_distortion:
        yaml += "distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]\n"
    (mav / "cam0" / "sensor.yaml").write_text(yaml)
    (mav / "imu0").mkdir(parents=True)
    imu = ["#ts,wx,wy,wz,ax,ay,az"]
    for k in range(30):
        ts = 1403636579763555584 + k * 5_000_000
        imu.append(f"{ts},{0.01 * k},0.0,-0.02,0.1,0.0,9.81")
    (mav / "imu0" / "data.csv").write_text("\n".join(imu))
    gt_dir = mav / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    rows = ["#ts,px,py,pz,qw,qx,qy,qz"]
    for k in range(6):
        ts = 1403636579763555584 + k * 25_000_000
        rows.append(f"{ts},{0.1 * k},0.5,1.0,1.0,0.0,0.0,0.0,0,0,0")
    (gt_dir / "data.csv").write_text("\n".join(rows))


def _kitti(root, rng, n=4):
    seq = root / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    img = _texture(rng)[:H, :W]
    for i in range(n):
        Image.fromarray(img).save(seq / "image_0" / f"{i:06d}.png")
        Image.fromarray(np.roll(img, 3, axis=1)).save(
            seq / "image_1" / f"{i:06d}.png")
    (seq / "times.txt").write_text("\n".join(f"{i * 0.1:.6f}"
                                             for i in range(n)))
    (seq / "calib.txt").write_text(
        "P0: 718.856 0 607.19 0 0 718.856 185.21 0 0 0 1 0\n"
        "P1: 718.856 0 607.19 -386.14 0 718.856 185.21 0 0 0 1 0\n")
    (root / "poses").mkdir()
    rows = []
    for i in range(n):
        T = np.hstack([np.eye(3), [[i * 0.5], [0.0], [0.0]]])
        rows.append(" ".join(f"{v:.6e}" for v in T.ravel()))
    (root / "poses" / "00.txt").write_text("\n".join(rows))


def _scannet(root, rng):
    for d in ("color", "depth", "intrinsic"):
        (root / d).mkdir()
    img = _texture(rng)[:H, :W]
    for i in range(3):
        Image.fromarray(img).convert("RGB").save(root / "color" / f"{i}.jpg")
        depth_mm = rng.integers(0, 4000, size=(H, W)).astype(np.uint16)
        Image.fromarray(depth_mm).save(root / "depth" / f"{i}.png")
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 577.87, 577.87, 319.5, 239.5
    np.savetxt(root / "intrinsic" / "intrinsic_depth.txt", K)


def _assert_same_frames(jds, tds):
    assert len(tds) == len(jds)
    jf, tf = list(jds), list(tds)
    assert len(tf) == len(jf) > 0
    for a, b in zip(jf, tf):
        assert b.frame_id == a.frame_id and b.timestamp == a.timestamp
        for key in ("gray", "right", "depth", "imu_t", "imu_omega",
                    "imu_acc"):
            va, vb = getattr(a, key), getattr(b, key)
            assert (va is None) == (vb is None), key
            if va is not None:
                assert vb.dtype == va.dtype, key
                np.testing.assert_array_equal(vb, va, err_msg=key)


def _assert_same_dict(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)


@pytest.mark.parametrize("kind", ["tum", "tum_window", "euroc",
                                  "euroc_mono", "kitti", "kitti_window",
                                  "scannet", "zju"])
def test_reader_matches_jax(tmp_path, rng, kind):
    if kind.startswith("tum"):
        _tum(tmp_path, rng)
        kw = dict(start=1, max_frames=2) if kind == "tum_window" else {}
        jds, tds = (JD.TumRgbdDataset(tmp_path, **kw),
                    TD.TumRgbdDataset(tmp_path, **kw))
        assert [p[1:] for p in tds.pairs] == [p[1:] for p in jds.pairs]
    elif kind in ("euroc", "euroc_mono"):
        stereo = kind == "euroc"
        _euroc(tmp_path, rng, stereo=stereo)
        jds = JD.EurocDataset(tmp_path, stereo=stereo)
        tds = TD.EurocDataset(tmp_path, stereo=stereo)
    elif kind.startswith("kitti"):
        _kitti(tmp_path, rng)
        kw = dict(start=1, max_frames=2) if kind == "kitti_window" else {}
        jds = JD.KittiDataset(tmp_path, "00", **kw)
        tds = TD.KittiDataset(tmp_path, "00", **kw)
    elif kind == "scannet":
        _scannet(tmp_path, rng)
        jds, tds = (JD.ScannetDataset(tmp_path, fps=30.0),
                    TD.ScannetDataset(tmp_path, fps=30.0))
    else:
        _euroc(tmp_path, rng, stereo=False, yaml_distortion=False)
        jds, tds = JD.ZjuDataset(tmp_path), TD.ZjuDataset(tmp_path)
    _assert_same_frames(jds, tds)
    _assert_same_dict(getattr(jds, "gt", None), getattr(tds, "gt", None))
    _assert_same_dict(getattr(jds, "calib", None),
                      getattr(tds, "calib", None))


@pytest.mark.parametrize("sensor", ["EUROC", "TUM_RGBD", "KITTI", "SCANNET",
                                    "ZJU", "PRIMESENSE", "KINECT_AZURE",
                                    "SAIGA_RAW"])
def test_create_dataset_matches_jax(tmp_path, rng, sensor):
    """The SensorType -> reader factory, live cameras refused alike."""
    _euroc(tmp_path, rng)
    js, ts = JSettings(), Settings()
    js.sensor_type, ts.sensor_type = (JSensorType[sensor],
                                      SensorType[sensor])
    js.input_type, ts.input_type = JInputType.Stereo, InputType.Stereo
    if sensor in ("PRIMESENSE", "KINECT_AZURE", "SAIGA_RAW"):
        for create in (JD.create_dataset, TD.create_dataset):
            with pytest.raises(NotImplementedError, match="live-camera"):
                create(ts if create is TD.create_dataset else js, tmp_path)
        return
    j, t = JD.create_dataset(js, tmp_path), TD.create_dataset(ts, tmp_path)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j)


def test_input_takes_calibration_like_jax(tmp_path, rng):
    """Input copies the dataset's intrinsics and resolution into the
    settings and builds the keypoint undistortion from its coefficients;
    the first frame's undistorted keypoints and IMU window agree."""
    _euroc(tmp_path, rng)
    js, ts = JSettings(), Settings()
    for s, it in ((js, JInputType.Mono), (ts, InputType.Mono)):
        s.input_type = it
        s.fd_features = 300
        s.fd_levels = 2
    ji = JInput(js, dataset=JD.EurocDataset(tmp_path))
    ti = Input(ts, dataset=TD.EurocDataset(tmp_path), device="cpu")
    for key in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(ts, key) == getattr(js, key), key
    jd, td = ji.preprocess.distortion, ti.preprocess.distortion
    for key in ("k1", "k2", "k3", "p1", "p2"):
        assert float(getattr(td, key)) == float(np.asarray(getattr(jd, key)))
    assert ti.depth_processor is None
    jf, tf = list(ji), list(ti)
    assert len(tf) == len(jf) == 3
    for a, b in zip(jf, tf):
        assert b.n == a.n
        # the packages order equal-score keypoints differently; the
        # fixture's principal point lies outside its 320x240 image, so far
        # keypoints leave the radial model's convergent region: the
        # Gauss-Newton inverse is compared where it lands in the image
        ua = a.uv[np.lexsort(a.uv.T)]
        ub = b.uv[np.lexsort(b.uv.T)]
        inside = ((ua >= 0) & (ua < [W, H])).all(1)
        assert inside.mean() > 0.5
        np.testing.assert_allclose(ub[inside], ua[inside], atol=1e-3)
        if a.imu_dt is not None:
            np.testing.assert_array_equal(b.imu_dt, a.imu_dt)
            np.testing.assert_array_equal(b.imu_omega, a.imu_omega)


def test_input_builds_depth_filter_when_enabled(tmp_path, rng):
    _tum(tmp_path, rng, n=1)
    s = Settings()
    s.input_type = InputType.RGBD
    s.bf = 40.0
    s.depth_filter_enable = True
    s.fd_features = 200
    inp = Input(s, dataset=TD.TumRgbdDataset(tmp_path), device="cpu")
    assert inp.depth_processor is not None
    assert inp.depth_processor.gauss_radius == s.depth_filter_gauss_radius
    (frame,) = list(inp)
    assert frame.n > 0 and (frame.depth > 0).any()


class _FakeClock:
    """Stands in for the ``time`` module of frontend/input.py: the clock
    moves only by ``sleep`` and by ``work`` (a frame's compute)."""

    def __init__(self, start: float = 100.0):
        self.now = start
        self.sleeps = []

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, seconds: float):
        self.sleeps.append(seconds)
        self.now += seconds

    def work(self, seconds: float):
        self.now += seconds


def test_playback_pacing(rng, monkeypatch):
    """Deployment-mode pacing (Input.cpp:240-303 + ResetTime) on a fake
    clock: at quarter speed (25 fps playback of 100 fps data) frame k is
    delivered no earlier than start + 0.04 k s, the sleeps making up what
    each frame's compute leaves of its 0.04 s; evaluation mode
    (paced=False) never sleeps (tests/test_datasets.py's scenario)."""
    from snakeslam_tpu_torch.frontend import input as IN

    s = Settings()
    s.input_type = InputType.Mono
    s.width, s.height = 64, 64
    s.fd_features = 32
    work = 0.013                       # seconds of compute a frame
    n = 6

    def fake_dataset():
        img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
        for i in range(n):
            yield TD.RawFrame(frame_id=i, timestamp=i * 0.01, gray=img)

    def run(paced: bool):
        clock = _FakeClock()
        monkeypatch.setattr(IN, "time", clock)
        inp = Input(s, dataset=fake_dataset(), device="cpu")
        process = inp.process_raw

        def timed(raw):
            clock.work(work)
            return process(raw)

        inp.process_raw = timed
        start = clock.now
        delivered = []
        for frame in inp.frames(paced=paced):
            assert frame.n > 0
            delivered.append(clock.now - start)
        return delivered, clock.sleeps

    s.dataset.playback_fps = 25.0
    s.dataset.playback_paced = True
    delivered, sleeps = run(paced=True)
    assert len(delivered) == n
    for k, t in enumerate(delivered):
        assert t >= 0.04 * k, (k, t)
        assert t == pytest.approx(0.04 * k + work, abs=1e-9)
    # frame 0 sets the schedule; every later frame sleeps what its
    # predecessor's compute left of the 0.04 s slot
    assert sleeps == pytest.approx([0.04 - work] * (n - 1), abs=1e-9)
    delivered, sleeps = run(paced=False)
    assert sleeps == []
    assert delivered == pytest.approx([work * (k + 1) for k in range(n)],
                                      abs=1e-9)


def test_tum_fixture_decodes_to_rendered_arrays(tmp_path):
    """The lane's writer: the reader gives back the rendered gray image
    (uint8) and depth (5000 per metre), the ground truth the trajectory's
    camera centres, and every frame holds world points in view."""
    from snakeslam_tpu_torch.utils import tum_fixture as TF
    from snakeslam_tpu_torch.utils.render_world import render_frame

    world = TF.lane_world(scale=0.5)
    trajectory = TF.lane_trajectory(3)
    info = TF.write_tum_fixture(tmp_path, world, trajectory)
    assert info["frames"] == 3 and info["min_points_in_view"] >= 150
    ds = TD.TumRgbdDataset(tmp_path)
    for raw, (t, T_cw) in zip(ds, trajectory):
        gray, z = render_frame(world, T_cw, with_depth=True)
        assert raw.timestamp == float(f"{t:.6f}")
        np.testing.assert_array_equal(raw.gray,
                                      np.clip(gray, 0, 255).astype(np.uint8))
        np.testing.assert_array_equal(
            raw.depth, np.round(z * 5000).astype(np.uint16).astype(np.float64)
            * TD.TumRgbdDataset.DEPTH_SCALE)
        assert ((z > 0) == (raw.depth > 0)).all() and (z > 0).mean() > 0.2
    centres = np.stack([np.linalg.inv(T)[:3, 3] for _, T in trajectory])
    np.testing.assert_allclose(ds.gt["p"], centres, atol=1e-8)
    assert TF.lane_trajectory(2)[1][0] == trajectory[1][0]
