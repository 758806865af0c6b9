"""Multi-device execution: a device mesh, the sharded Hamming matcher and the
sharded Gauss-Newton bundle-adjustment step.

Counterpart of ``snakeslam_tpu/parallel/multichip.py``.  The JAX package
shards with ``jax.shard_map`` over a 1-D ``dp`` mesh: one process drives
every device, points and observations are split over the mesh, and one
``psum`` reduces the shards' partial reduced camera systems.  The PyTorch
counterpart of that single-controller mesh is a list of devices driven by
one process:

  * a ``Mesh`` is an ordered tuple of devices, one per shard: shard i of a
    CUDA mesh on ``cuda:{i % device_count}``, every shard of a CPU mesh on
    the CPU (as the JAX tests' virtual CPU devices share one host);
  * each shard's tensors live on its device and its work is queued there;
  * the ``psum`` is a reduce on the mesh's first device: each shard's
    partial system is copied there (a peer copy between cards) and added
    in shard order, so a rerun is bit-identical whatever the placement.

Cameras are the small shared state (copied to every shard), points the
large independent state (split into contiguous equal blocks): the reduce
moves O(C^2) data whatever the point count.  A mesh always has the shard
count asked for; the JAX package's ``GlobalBA`` instead solves unsharded
when fewer devices exist than ``n_devices``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops import ba as BA
from snakeslam_tpu_torch.ops.descriptors import hamming_matrix
from snakeslam_tpu_torch.ops.linalg import inv3x3
from snakeslam_tpu_torch.utils.ba_fixtures import make_synthetic_ba_problem

# the per-point fields of a BAProblem, split over the shards; the camera
# and relative-pose-constraint fields are copied to every shard
_POINT_FIELDS = ("points", "point_valid", "obs_cam", "obs_uv", "obs_right",
                 "obs_weight", "obs_valid")


@dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D mesh, one per shard, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> bool:
        """Every shard on a device of its own."""
        return len(set(self.devices)) == len(self.devices)


def make_mesh(n_devices: int, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards: on CUDA shard i on
    ``cuda:{i % torch.cuda.device_count()}`` (``device`` defaults to
    ``cuda``), on the CPU every shard on the CPU."""
    if n_devices < 1:
        raise ValueError(f"make_mesh: {n_devices} shards")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device")
        return Mesh(tuple(torch.device("cuda", i % count)
                          for i in range(n_devices)))
    if device.type == "cpu":
        return Mesh((torch.device("cpu"),) * n_devices)
    raise ValueError(f"make_mesh: unsupported device {device}")


def _blocks(x: torch.Tensor, mesh: Mesh, what: str) -> list[torch.Tensor]:
    """``x`` split on its leading axis into ``mesh.size`` contiguous equal
    blocks, block k on shard k's device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{what}: {n} rows do not split into {mesh.size} "
                         "equal shards")
    q = n // mesh.size
    return [x[k * q:(k + 1) * q].to(dev)
            for k, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# sharded Hamming matching
# ---------------------------------------------------------------------------

def sharded_hamming_topk(mesh: Mesh):
    """Returns fn(point_bits (P, 256), frame_bits (N, 256)) -> (best_dist
    (P,) int32, best_idx (P,) int32) on ``mesh.devices[0]``: the points
    split over the shards, the frame copied to every shard, each shard's
    minimum and first index of it, concatenated in shard order."""

    def fn(point_bits: torch.Tensor, frame_bits: torch.Tensor):
        dist, idx = [], []
        for dev, pb in zip(mesh.devices,
                           _blocks(point_bits, mesh, "sharded_hamming_topk")):
            H = hamming_matrix(pb, frame_bits.to(dev))
            dist.append(torch.amin(H, dim=1))
            idx.append(torch.argmin(H, dim=1).to(torch.int32))
        home = mesh.devices[0]
        return (torch.cat([d.to(home) for d in dist]),
                torch.cat([i.to(home) for i in idx]))

    return fn


# ---------------------------------------------------------------------------
# sharded BA step
# ---------------------------------------------------------------------------

def shard_problem(problem: BA.BAProblem, mesh: Mesh) -> tuple[BA.BAProblem,
                                                              ...]:
    """A BAProblem as one BAProblem a shard: the per-point fields split into
    contiguous equal blocks on the shards' devices, the camera and
    relative-pose-constraint fields copied to every shard.  Raises
    ``ValueError`` when the point slots do not split evenly."""
    split = {k: _blocks(getattr(problem, k), mesh, "shard_problem")
             for k in _POINT_FIELDS}
    return tuple(
        BA.BAProblem(**{
            k: split[k][i] if k in split else v.to(dev)
            for k, v in problem._asdict().items()})
        for i, dev in enumerate(mesh.devices))


def _shard_partials(problem: BA.BAProblem, cam: Pinhole, bf, cam_pose,
                    points, lam: float):
    """One shard's Huber-weighted Schur pieces: its partial reduced camera
    system S (C, C, 6, 6) and gradient (C, 6), and what its point
    back-substitution needs (Hpp^-1, Y, g_p, the observations' camera
    slots with C for a dropped one)."""
    C = cam_pose.shape[0]
    r, A, Bj, valid, has_stereo = BA._point_residuals(
        problem, cam, bf, cam_pose, points)
    chi2 = BA._obs_chi2(r, problem.obs_weight, has_stereo)
    delta_h = torch.where(has_stereo, 2.3, 2.1)
    e = torch.sqrt(chi2 + 1e-12)
    huber = torch.clamp(delta_h / e, max=1.0)
    w = torch.where(valid, problem.obs_weight**2 * huber, 0.0)
    eye3 = torch.eye(3, dtype=cam_pose.dtype, device=cam_pose.device)
    Hpp = torch.einsum("pmki,pm,pmkj->pij", Bj, w, Bj) + (lam + 1e-6) * eye3
    Hpp_inv = inv3x3(Hpp)
    cidx = torch.where(valid, problem.obs_cam.long(), C)
    S, g_hat, Y, g_p = BA._reduced_camera_system(A, Bj, r, w, Hpp_inv, cidx,
                                                 C)
    return S, g_hat, (Hpp_inv, Y, g_p, cidx)


def sharded_ba_step(mesh: Mesh, cam: Pinhole, bf, n_iters: int = 1,
                    lam: float = 1e-4):
    """Returns fn(shards) -> (cam_pose (C, 4, 4), points (P, 3)) on
    ``mesh.devices[0]``, for ``shards = shard_problem(problem, mesh)``:
    ``n_iters`` Gauss-Newton iterations in the problem's dtype.  Each
    iteration: each shard's partial reduced camera system on its device;
    the reduce in shard order on the first device; the relative-pose
    factors added once; the damped, masked dense solve there; the camera
    update sent back to every shard for its point back-substitution."""

    def step(shards):
        home = mesh.devices[0]
        p0 = shards[0]
        dtype = p0.cam_pose.dtype
        cams = [Pinhole(*(c.to(s.cam_pose.device, dtype) for c in cam))
                for s in shards]
        bfs = [torch.as_tensor(bf).to(s.cam_pose.device, dtype)
               for s in shards]
        free = (p0.cam_valid & (~p0.cam_fixed)).to(dtype)
        cam_pose = p0.cam_pose
        points = [s.points for s in shards]
        for _ in range(n_iters):
            parts = [_shard_partials(s, cm, b, cam_pose.to(s.cam_pose.device),
                                     pts, lam)
                     for s, cm, b, pts in zip(shards, cams, bfs, points)]
            S, g_hat = parts[0][0], parts[0][1]
            for S_k, g_k, _ in parts[1:]:
                S = S + S_k.to(home)
                g_hat = g_hat + g_k.to(home)
            # the IMU relative-pose factors, once, after the reduce
            S, g_hat, _ = BA._add_rpc(p0, cam_pose, S, g_hat)
            delta_c = BA._camera_step(S, g_hat, free, lam)
            points = [BA._back_substitute(s, pts,
                                          delta_c.to(s.points.device),
                                          *pieces)
                      for s, pts, (_, _, pieces) in zip(shards, points,
                                                        parts)]
            cam_pose = lie.se3_exp(delta_c) @ cam_pose
        return cam_pose, torch.cat([p.to(home) for p in points])

    return step


# ---------------------------------------------------------------------------
# dry run
# ---------------------------------------------------------------------------

def dryrun_multichip(n_devices: int, device=None) -> None:
    """The multi-device path on an ``n_devices``-shard mesh (``device``
    defaults to ``cuda``): two sharded BA iterations on a synthetic problem
    (C = 8, P = 16 n, M = 4) with finite results, the sharded matcher on
    (32 n, 256) against (128, 256) bits equal to the unsharded minimum and
    first index, and ``GlobalBA`` with ``n_devices = n`` on a small map: a
    mesh of n shards whose ``full_ba(2)`` moves the perturbed points.
    Raises on any failure."""
    device = torch.device("cuda" if device is None else device)
    mesh = make_mesh(n_devices, device)
    home = mesh.devices[0]
    cam = Pinhole.create(458.654, 457.296, 367.215, 248.375, device=home)
    bf = torch.tensor(458.654 * 0.11, device=home)

    problem, _, _ = make_synthetic_ba_problem(C=8, P=16 * n_devices, M=4,
                                              seed=0, device=home)
    step = sharded_ba_step(mesh, cam, bf, n_iters=2)
    cam_pose, points = step(shard_problem(problem, mesh))
    if not (torch.isfinite(cam_pose).all() and torch.isfinite(points).all()):
        raise RuntimeError("dryrun_multichip: the sharded BA step gave NaN")

    rng = np.random.default_rng(0)
    pb = torch.as_tensor(rng.integers(0, 2, size=(32 * n_devices, 256))
                         .astype(np.int8), device=home)
    fb = torch.as_tensor(rng.integers(0, 2, size=(128, 256))
                         .astype(np.int8), device=home)
    d, idx = sharded_hamming_topk(mesh)(pb, fb)
    H = hamming_matrix(pb, fb)
    if not (torch.equal(d, torch.amin(H, dim=1))
            and torch.equal(idx, torch.argmin(H, dim=1).to(torch.int32))):
        raise RuntimeError("dryrun_multichip: the sharded matcher differs "
                           "from the unsharded one")

    _dryrun_system_gba(n_devices, device)


def dryrun_map(n_devices: int):
    """The dry run's map: 4 keyframes 0.2 m apart observing 48 points 8-16
    m ahead (pixel-exact observations, the points perturbed by 5 cm), with
    settings for ``n_devices``.  Returns (settings, map, point ids)."""
    from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
    from snakeslam_tpu_torch.system.settings import InputType, Settings

    rng = np.random.default_rng(1)
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.n_devices = n_devices
    n_feat, n_kf, n_pts = 64, 4, 48
    smap = SlamMap(16, 512, n_feat)

    pts_w = rng.uniform(-4, 4, size=(n_pts, 3)) + np.array([0, 0, 12.0])
    kf_ids = []
    for k in range(n_kf):
        pose = np.eye(4)
        pose[:3, 3] = [0.2 * k, 0.0, 0.0]
        pc = pts_w @ pose[:3, :3].T + pose[:3, 3]
        uv = np.stack([
            s.fx * pc[:, 0] / pc[:, 2] + s.cx,
            s.fy * pc[:, 1] / pc[:, 2] + s.cy,
        ], axis=1)
        frame = FrameData(
            frame_id=k, timestamp=0.1 * k,
            uv=np.zeros((n_feat, 2)), octave=np.zeros(n_feat, np.int32),
            angle=np.zeros(n_feat),
            descriptors=rng.integers(0, 256, (n_feat, 32)).astype(np.uint8),
            right=np.full(n_feat, -1.0), depth=np.full(n_feat, -1.0),
        )
        frame.uv[:n_pts] = uv
        frame.pose_cw = pose
        kf_ids.append(smap.allocate_keyframe(frame))
    ids = smap.allocate_points_bulk(
        pts_w + rng.normal(size=pts_w.shape) * 0.05,
        rng.integers(0, 256, (n_pts, 32)).astype(np.uint8),
        kf_ids[0], np.full(n_pts, 12.0), np.zeros(n_pts, np.int32),
        np.tile(np.array([0, 0, -1.0]), (n_pts, 1)),
    )
    for k in kf_ids:
        smap.add_observations_bulk(k, np.arange(n_pts), ids)
    return s, smap, ids


def _dryrun_system_gba(n_devices: int, device) -> None:
    """``GlobalBA`` with ``n_devices`` on ``dryrun_map``: the path the loop
    closer, ``finalize`` and the IMU solver take."""
    from snakeslam_tpu_torch.optim.gba import GlobalBA

    s, smap, ids = dryrun_map(n_devices)
    gba = GlobalBA(s, smap, device)
    if gba._mesh is None or gba._mesh.size != n_devices:
        raise RuntimeError("dryrun_multichip: GlobalBA built no "
                           f"{n_devices}-shard mesh")
    before = smap.pt_pos[ids].copy()
    gba.full_ba(iterations=2)
    after = smap.pt_pos[ids]
    if not np.isfinite(after).all():
        raise RuntimeError("dryrun_multichip: the sharded full BA gave NaN")
    if not np.abs(after - before).max() > 0:
        raise RuntimeError("dryrun_multichip: the sharded full BA moved no "
                           "point")
