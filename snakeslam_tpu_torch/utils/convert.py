"""State carried across from the JAX package, as numpy arrays, to tensors.

The system has no learned weights; what the two packages share is state:
local-map snapshots, frame features, camera intrinsics, pose observations
and the windowed tracker's carry.  These functions take that state as numpy
arrays (``np.asarray`` of the JAX arrays) and return the port's tensors on
a given device, so the parity tests feed both packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
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


def window_carry_from_numpy(carry, device):
    """The window carry (T (4,4), velocity (4,4), dec_state (DEC_SIZE,),
    stopped ()) -> tensors."""
    T, vel, dec, stopped = carry
    return (_f32(T, device), _f32(vel, device), _f32(dec, device),
            _bool(stopped, device))
