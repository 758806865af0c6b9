"""State carried across from the JAX package, as numpy arrays, to tensors.

The system has no learned weights; what the two packages share is state:
local-map snapshots, frame features, camera intrinsics, pose observations,
bundle-adjustment problems, the windowed tracker's carry and the IMU state
solver's state.  These
functions take that state as numpy arrays (``np.asarray`` of the JAX
arrays) and return the port's tensors on a given device (the solver's
state stays numpy, as the solver keeps it), so the parity tests feed both
packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops.ba import BAProblem
from snakeslam_tpu_torch.ops.matching import FrameFeatures, LocalMapPoints
from snakeslam_tpu_torch.ops.pose_solver import PoseObs


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def _bool(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=bool), device=device)


def _bits(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.int8), device=device)


def local_map_from_numpy(lm, device) -> LocalMapPoints:
    """Fields of a LocalMapPoints (position, normal, desc_bits, ref_depth,
    ref_level, angle, valid) as numpy arrays -> the port's tensors."""
    return LocalMapPoints(
        position=_f32(lm.position, device),
        normal=_f32(lm.normal, device),
        desc_bits=_bits(lm.desc_bits, device),
        ref_depth=_f32(lm.ref_depth, device),
        ref_level=_i32(lm.ref_level, device),
        angle=_f32(lm.angle, device),
        valid=_bool(lm.valid, device),
    )


def frame_features_from_numpy(ff, device) -> FrameFeatures:
    """Fields of a FrameFeatures (uv, right, octave, angle, desc_bits,
    valid) -> the port's tensors."""
    return FrameFeatures(
        uv=_f32(ff.uv, device),
        right=_f32(ff.right, device),
        octave=_i32(ff.octave, device),
        angle=_f32(ff.angle, device),
        desc_bits=_bits(ff.desc_bits, device),
        valid=_bool(ff.valid, device),
    )


def pinhole_from_numpy(cam, device) -> Pinhole:
    """(fx, fy, cx, cy) scalars -> a Pinhole of 0-d float32 tensors."""
    return Pinhole(*(_f32(v, device) for v in cam))


def pose_obs_from_numpy(obs, device) -> PoseObs:
    """Fields of a PoseObs (points, uv, right, weight, mask) -> tensors."""
    return PoseObs(
        points=_f32(obs.points, device),
        uv=_f32(obs.uv, device),
        right=_f32(obs.right, device),
        weight=_f32(obs.weight, device),
        mask=_bool(obs.mask, device),
    )


def ba_problem_from_numpy(problem, device, dtype=None) -> BAProblem:
    """Fields of a BAProblem as numpy arrays -> the port's BAProblem on
    ``device``: float fields as ``dtype`` (None keeps each array's float
    dtype), slots as int32, flags as bool."""
    out = {}
    for k, v in problem._asdict().items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            t = torch.tensor(v, device=device)
            out[k] = t if dtype is None else t.to(dtype)
        elif v.dtype == bool:
            out[k] = _bool(v, device)
        else:
            out[k] = _i32(v, device)
    return BAProblem(**out)


def window_carry_from_numpy(carry, device):
    """The window carry (T (4,4), velocity (4,4), dec_state (DEC_SIZE,),
    stopped ()) -> tensors."""
    T, vel, dec, stopped = carry
    return (_f32(T, device), _f32(vel, device), _f32(dec, device),
            _bool(stopped, device))


# ---------------------------------------------------------------------------
# IMU state solver
# ---------------------------------------------------------------------------

_SOLVER_SCALARS = ("gravity_initialized", "gyro_initialized", "init_scale",
                   "gyro_iterations", "init_done_time", "refine_idx",
                   "current_gyro_weight", "current_acc_weight",
                   "map_reset_requested")
_SOLVER_VECTORS = ("bg", "ba", "gravity")


def imu_solver_state(sol) -> dict:
    """The state of an IMU state solver of either package as plain numpy:
    the keyframe edges with their raw samples, the biases, gravity, the
    stage (by name), the weights and the refinement schedule's position.
    The map's ``kf_velocity`` / ``kf_bias_*`` travel with the map
    (``utils/loop_problems.clone_map``)."""
    state = {k: getattr(sol, k) for k in _SOLVER_SCALARS}
    state.update({k: np.array(getattr(sol, k), dtype=np.float64)
                  for k in _SOLVER_VECTORS})
    state["stage"] = sol.stage.name
    state["edges"] = {
        int(kf): dict(prev_kf=int(e.prev_kf), omega=np.array(e.omega),
                      acc=np.array(e.acc), dt=np.array(e.dt))
        for kf, e in sol.edges.items()}
    state["pending_samples"] = [tuple(np.array(a) for a in s)
                                for s in sol.pending_samples]
    return state


def load_imu_solver_state(sol, state: dict, edge_cls) -> None:
    """Put ``imu_solver_state``'s snapshot into ``sol`` (a solver of either
    package; ``edge_cls`` is that package's ``ImuEdge``).  Every edge is
    preintegrated anew at the snapshot's biases by the solver's own
    function."""
    for k in _SOLVER_SCALARS:
        setattr(sol, k, state[k])
    for k in _SOLVER_VECTORS:
        setattr(sol, k, state[k].copy())
    sol.stage = type(sol.stage)[state["stage"]]
    sol.edges = {
        kf: edge_cls(prev_kf=e["prev_kf"], omega=e["omega"].copy(),
                     acc=e["acc"].copy(), dt=e["dt"].copy())
        for kf, e in state["edges"].items()}
    sol.pending_samples = [tuple(a.copy() for a in s)
                           for s in state["pending_samples"]]
    sol.recompute_weights()
