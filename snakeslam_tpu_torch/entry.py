"""Entry points: the fine-tracking step on seeded inputs, and the
multi-device dry run.

Counterpart of ``__graft_entry__.py``:

  entry(device)            -> (fn, example_args): ``models/tracking_step.
                              fine_step`` (the local-map projection match
                              and the robust pose refine of one frame) on
                              the same seeded inputs (N = 256 features,
                              P = 512 map points, L = 4 levels);
                              ``fn(*example_args)`` returns (T, n_inliers);
  dryrun_multichip(n, device) -> the sharded BA step, the sharded matcher
                              and the sharded ``GlobalBA`` on an n-shard
                              mesh (``parallel/multichip.py``).

Both default to the card (``device="cuda"``); pass ``"cpu"`` to run them
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.models import tracking_step as TS
from snakeslam_tpu_torch.ops.matching import FrameFeatures, LocalMapPoints
from snakeslam_tpu_torch.parallel.multichip import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    device = torch.device("cuda" if device is None else device)
    N, P, L = 256, 512, 4
    rng = np.random.default_rng(0)
    scales = 1.2 ** np.arange(L, dtype=np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    lm = LocalMapPoints(
        position=f32(rng.uniform(-4, 4, size=(P, 3))
                     + np.array([0, 0, 12.0])),
        normal=f32(np.tile(np.array([0, 0, -1.0]), (P, 1))),
        desc_bits=torch.as_tensor(
            rng.integers(0, 2, size=(P, 256)).astype(np.int8), device=device),
        ref_depth=torch.full((P,), 12.0, device=device),
        ref_level=torch.zeros((P,), dtype=torch.int32, device=device),
        angle=torch.zeros((P,), device=device),
        valid=torch.ones((P,), dtype=torch.bool, device=device),
    )
    frame = FrameFeatures(
        uv=f32(rng.uniform([0, 0], [752, 480], size=(N, 2))),
        right=torch.full((N,), -1.0, device=device),
        octave=torch.zeros((N,), dtype=torch.int32, device=device),
        angle=torch.zeros((N,), device=device),
        desc_bits=torch.as_tensor(
            rng.integers(0, 2, size=(N, 256)).astype(np.int8), device=device),
        valid=torch.ones((N,), dtype=torch.bool, device=device),
    )
    cam = Pinhole.create(458.654, 457.296, 367.215, 248.375, device=device)
    eye = torch.eye(4, device=device)
    example_args = (
        lm, frame, eye,
        torch.zeros((N, 3), device=device),              # coarse_pos
        torch.zeros((N,), dtype=torch.bool, device=device),  # coarse_matched
        cam, scalar(458.654 * 0.11),
        f32([0.0, 0.0, 752.0, 480.0]),
        f32(scales), scalar(np.log(1.2)),
        scalar(5.0),                                     # fine search th
        eye, scalar(0.0), scalar(0.0),
    )

    def fn(*args):
        out = TS.fine_step(*args)
        return out["T"], out["n_inliers"]

    return fn, example_args
