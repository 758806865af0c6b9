"""Dataset loaders: EuRoC (ASL), TUM-RGBD, KITTI odometry, ScanNet, ZJU.

Counterpart of ``snakeslam_tpu/frontend/datasets.py``: the same host-side
readers.  Replacement for the saiga dataset loaders the reference
instantiates per SensorType (reference: Snake/Preprocess/Input.cpp:100-234
— EuRoCDataset, TumRGBDDataset, KittiDataset + GT export at :177-196).
Loaders yield ``RawFrame`` records (grayscale arrays + optional right/depth
image + the IMU window since the previous frame) and expose ground truth
for ATE evaluation.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class RawFrame:
    frame_id: int
    timestamp: float
    gray: np.ndarray                 # (H, W) uint8
    right: np.ndarray | None = None  # (H, W) stereo right
    depth: np.ndarray | None = None  # (H, W) float metric depth
    imu_t: np.ndarray | None = None
    imu_omega: np.ndarray | None = None
    imu_acc: np.ndarray | None = None


def _load_gray(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


# ---------------------------------------------------------------------------
# EuRoC MAV (ASL format)
# ---------------------------------------------------------------------------

class EurocDataset:
    """<root>/mav0/{cam0,cam1}/data.csv + data/, imu0/data.csv,
    state_groundtruth_estimate0/data.csv."""

    def __init__(self, root: str | Path, stereo: bool = False,
                 start: int = 0, max_frames: int = -1):
        self.root = Path(root)
        mav = self.root / "mav0"
        self.stereo = stereo
        self.cam0 = self._read_image_index(mav / "cam0")
        self.cam1 = self._read_image_index(mav / "cam1") if stereo else []
        self.imu = self._read_imu(mav / "imu0" / "data.csv")
        self.gt = self._read_gt(
            mav / "state_groundtruth_estimate0" / "data.csv"
        )
        self.start = start
        self.max_frames = max_frames
        self.calib = self._read_calib(mav / "cam0" / "sensor.yaml")

    @staticmethod
    def _read_image_index(cam_dir: Path):
        out = []
        csv_path = cam_dir / "data.csv"
        if not csv_path.exists():
            return out
        with open(csv_path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts_ns = int(row[0])
                out.append((ts_ns * 1e-9, cam_dir / "data" / row[1].strip()))
        return out

    @staticmethod
    def _read_imu(path: Path):
        if not path.exists():
            return None
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(v) for v in row])
        if not rows:
            return None
        arr = np.asarray(rows)
        return dict(
            t=arr[:, 0] * 1e-9,
            omega=arr[:, 1:4],
            acc=arr[:, 4:7],
        )

    @staticmethod
    def _read_gt(path: Path):
        if not path.exists():
            return None
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(v) for v in row[:8]])
        if not rows:
            return None
        arr = np.asarray(rows)
        return dict(t=arr[:, 0] * 1e-9, p=arr[:, 1:4], q_wxyz=arr[:, 4:8])

    @staticmethod
    def _read_calib(path: Path):
        if not path.exists():
            return None
        import yaml

        with open(path) as f:
            y = yaml.safe_load(f)
        out = {}
        if "intrinsics" in y:
            fx, fy, cx, cy = y["intrinsics"]
            out.update(fx=fx, fy=fy, cx=cx, cy=cy)
        if "distortion_coefficients" in y:
            out["distortion"] = list(y["distortion_coefficients"])
        if "resolution" in y:
            out["width"], out["height"] = y["resolution"]
        return out or None

    def __len__(self):
        n = len(self.cam0) - self.start
        return n if self.max_frames < 0 else min(n, self.max_frames)

    def __iter__(self):
        imu = self.imu
        prev_ts = None
        end = (len(self.cam0) if self.max_frames < 0
               else min(len(self.cam0), self.start + self.max_frames))
        for i in range(self.start, end):
            ts, path = self.cam0[i]
            frame = RawFrame(
                frame_id=i - self.start, timestamp=ts, gray=_load_gray(path)
            )
            if self.stereo and i < len(self.cam1):
                frame.right = _load_gray(self.cam1[i][1])
            if imu is not None and prev_ts is not None:
                sel = (imu["t"] > prev_ts) & (imu["t"] <= ts)
                frame.imu_t = imu["t"][sel]
                frame.imu_omega = imu["omega"][sel]
                frame.imu_acc = imu["acc"][sel]
            prev_ts = ts
            yield frame


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

class TumRgbdDataset:
    """<root>/rgb.txt + depth.txt + groundtruth.txt; depth scale 1/5000."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str | Path, start: int = 0, max_frames: int = -1,
                 max_dt: float = 0.03):
        self.root = Path(root)
        rgb = self._read_list(self.root / "rgb.txt")
        depth = self._read_list(self.root / "depth.txt")
        self.gt = self._read_gt(self.root / "groundtruth.txt")
        # associate rgb & depth by timestamp
        self.pairs = []
        if rgb and depth:
            dts = np.array([t for t, _ in depth])
            for t, p in rgb:
                j = int(np.argmin(np.abs(dts - t)))
                if abs(dts[j] - t) <= max_dt:
                    self.pairs.append((t, p, depth[j][1]))
        self.start = start
        self.max_frames = max_frames

    def _read_list(self, path: Path):
        out = []
        if not path.exists():
            return out
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, name = line.split()[:2]
                out.append((float(t), self.root / name))
        return out

    @staticmethod
    def _read_gt(path: Path):
        if not path.exists():
            return None
        from snakeslam_tpu_torch.core.trajectory import read_tum

        ts, pos, quat = read_tum(path)
        return dict(t=ts, p=pos, q_wxyz=quat)

    def __len__(self):
        n = len(self.pairs) - self.start
        return n if self.max_frames < 0 else min(n, self.max_frames)

    def __iter__(self):
        end = (len(self.pairs) if self.max_frames < 0
               else min(len(self.pairs), self.start + self.max_frames))
        for i in range(self.start, end):
            ts, rgb_path, depth_path = self.pairs[i]
            from PIL import Image

            depth_raw = np.asarray(Image.open(depth_path))
            yield RawFrame(
                frame_id=i - self.start,
                timestamp=ts,
                gray=_load_gray(rgb_path),
                depth=depth_raw.astype(np.float64) * self.DEPTH_SCALE,
            )


# ---------------------------------------------------------------------------
# KITTI odometry
# ---------------------------------------------------------------------------

class KittiDataset:
    """<root>/sequences/<seq>/image_{0,1}/%06d.png + times.txt;
    GT poses in <root>/poses/<seq>.txt."""

    def __init__(self, root: str | Path, sequence: str = "00",
                 stereo: bool = True, start: int = 0, max_frames: int = -1):
        self.root = Path(root)
        seq = self.root / "sequences" / sequence
        self.left_dir = seq / "image_0"
        self.right_dir = seq / "image_1"
        self.stereo = stereo and self.right_dir.exists()
        times_path = seq / "times.txt"
        self.times = (
            np.loadtxt(times_path) if times_path.exists() else None
        )
        self.images = sorted(self.left_dir.glob("*.png"))
        self.gt = self._read_gt(self.root / "poses" / f"{sequence}.txt")
        self.calib = self._read_calib(seq / "calib.txt")
        self.start = start
        self.max_frames = max_frames

    @staticmethod
    def _read_gt(path: Path):
        if not path.exists():
            return None
        mats = np.loadtxt(path).reshape(-1, 3, 4)
        p = mats[:, :, 3]
        return dict(t=np.arange(len(mats), dtype=float), p=p, T_wc=mats)

    @staticmethod
    def _read_calib(path: Path):
        if not path.exists():
            return None
        out = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                P = np.array(vals.split(), dtype=float).reshape(3, 4)
                out[key.strip()] = P
        if "P0" in out:
            P0 = out["P0"]
            out.update(fx=P0[0, 0], fy=P0[1, 1], cx=P0[0, 2], cy=P0[1, 2])
            if "P1" in out:
                out["bf"] = -out["P1"][0, 3]
        return out

    def __len__(self):
        n = len(self.images) - self.start
        return n if self.max_frames < 0 else min(n, self.max_frames)

    def __iter__(self):
        end = (len(self.images) if self.max_frames < 0
               else min(len(self.images), self.start + self.max_frames))
        for i in range(self.start, end):
            ts = float(self.times[i]) if self.times is not None else i * 0.1
            frame = RawFrame(
                frame_id=i - self.start, timestamp=ts,
                gray=_load_gray(self.images[i]),
            )
            if self.stereo:
                rp = self.right_dir / self.images[i].name
                if rp.exists():
                    frame.right = _load_gray(rp)
            yield frame


class ScannetDataset:
    """<root>/color/%d.jpg + depth/%d.png (millimeters) +
    intrinsic/intrinsic_depth.txt (ScanNet export layout)."""

    DEPTH_SCALE = 1.0 / 1000.0

    def __init__(self, root: str | Path, fps: float = 30.0, start: int = 0,
                 max_frames: int = -1):
        self.root = Path(root)
        color = self.root / "color"
        self.images = sorted(
            color.glob("*.jpg"), key=lambda p: int(p.stem)
        ) if color.exists() else []
        self.fps = fps
        self.start = start
        self.max_frames = max_frames
        self.calib = self._read_calib(
            self.root / "intrinsic" / "intrinsic_depth.txt"
        )

    @staticmethod
    def _read_calib(path: Path):
        if not path.exists():
            return None
        K = np.loadtxt(path)
        return dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2])

    def __len__(self):
        n = len(self.images) - self.start
        return n if self.max_frames < 0 else min(n, self.max_frames)

    def __iter__(self):
        from PIL import Image

        end = (len(self.images) if self.max_frames < 0
               else min(len(self.images), self.start + self.max_frames))
        for i in range(self.start, end):
            p = self.images[i]
            frame = RawFrame(
                frame_id=i - self.start,
                timestamp=int(p.stem) / self.fps,
                gray=_load_gray(p),
            )
            dp = self.root / "depth" / f"{p.stem}.png"
            if dp.exists():
                frame.depth = (np.asarray(Image.open(dp)).astype(np.float64)
                               * self.DEPTH_SCALE)
            yield frame


class ZjuDataset(EurocDataset):
    """ZJU-SenseTime VISLAM sequences ship in the EuRoC/ASL layout
    (mav0/camera + imu csv); the EuRoC loader covers them."""


def create_dataset(settings, root: str | Path):
    """SensorType -> loader factory (Input::CreateCamera analog,
    Input.cpp:100-234)."""
    from snakeslam_tpu_torch.system.settings import InputType, SensorType

    st = settings.sensor_type
    if st == SensorType.EUROC:
        return EurocDataset(
            root, stereo=settings.input_type == InputType.Stereo,
            start=settings.dataset.start_frame,
            max_frames=settings.dataset.max_frames,
        )
    if st == SensorType.TUM_RGBD:
        return TumRgbdDataset(
            root, start=settings.dataset.start_frame,
            max_frames=settings.dataset.max_frames,
        )
    if st == SensorType.KITTI:
        return KittiDataset(
            root, stereo=settings.input_type == InputType.Stereo,
            start=settings.dataset.start_frame,
            max_frames=settings.dataset.max_frames,
        )
    if st == SensorType.SCANNET:
        return ScannetDataset(
            root, start=settings.dataset.start_frame,
            max_frames=settings.dataset.max_frames,
        )
    if st == SensorType.ZJU:
        return ZjuDataset(
            root, start=settings.dataset.start_frame,
            max_frames=settings.dataset.max_frames,
        )
    if st in (SensorType.PRIMESENSE, SensorType.KINECT_AZURE,
              SensorType.SAIGA_RAW):
        raise NotImplementedError(
            f"{st.name} is a live-camera input; this environment has no "
            "camera hardware. Use a recorded dataset (EUROC/TUM_RGBD/"
            "KITTI/SCANNET/ZJU) or the synthetic source."
        )
    raise ValueError(f"unsupported sensor type {st}")
