"""Pose-graph optimization over SE3 or Sim3, Gauss-Newton.

Counterpart of ``snakeslam_tpu/ops/pgo.py`` (the reference's PGORec /
PGOSim3Rec): vertices are keyframe poses, edges relative-pose measurements
(spanning tree + covisibility + the loop edge); the Sim3 variant absorbs
monocular scale drift.  The normal equations are assembled densely and
solved by one Cholesky factorization per step.

Where the JAX package scatter-adds the per-edge blocks into the system,
this module contracts them with one-hot vertex matrices (a matrix product,
summed in a fixed order), so a rerun on the card is bit-identical.  The
accept test is a ``torch.where``: the GN loop never reads a device value on
the host.  Loop closing runs it in float64 on either device; on the card
``solve_pgo`` is a compiled program (``utils/graphs.py``), one captured
CUDA graph per graph size, ``iterations``, ``use_sim3`` and ``damping``
(static), as the JAX package jits it.  Loop closing pads each graph to
power-of-two vertex and edge counts (``padded``), so that the sizes, and
with them the graphs, repeat from one loop correction to the next.

Conventions: poses are world->camera (Sim3 poses carry sR); edge_T
approximates T_j @ T_i^-1; residual = log(T_j T_i^-1 edge_T^-1); the
update is T <- exp(delta) @ T.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.ops.ba import _one_hot
from snakeslam_tpu_torch.ops.linalg import solve_psd
from snakeslam_tpu_torch.utils import graphs


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (V, 4, 4)
    fixed: torch.Tensor        # (V,) bool
    valid: torch.Tensor        # (V,) bool
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    edge_T: torch.Tensor       # (E, 4, 4) measured relative pose
    edge_weight: torch.Tensor  # (E,)
    edge_valid: torch.Tensor   # (E,) bool


def sim3_adjoint(S: torch.Tensor) -> torch.Tensor:
    """Adjoint of Sim3 for tangent order (v, w, sigma): (..., 7, 7)."""
    s = lie.sim3_scale(S)
    R = lie.sim3_rotation(S)
    t = S[..., :3, 3]
    top = torch.cat([s[..., None, None] * R, lie.hat(t) @ R,
                     -t[..., :, None]], dim=-1)
    zt = torch.zeros_like(t)[..., :, None]
    mid = torch.cat([torch.zeros_like(R), R, zt], dim=-1)
    bot = torch.cat([torch.zeros_like(t), torch.zeros_like(t),
                     torch.ones_like(s)[..., None]], dim=-1)[..., None, :]
    return torch.cat([top, mid, bot], dim=-2)


def _se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    top = torch.cat([R, lie.hat(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _solve_pgo(graph: PoseGraph, iterations: int = 20,
               use_sim3: bool = False, damping: float = 1e-6):
    """Gauss-Newton on the pose graph.  Returns (poses, final_cost) as
    device tensors of the graph's dtype (as ``solve_pgo``: the graph's
    buffers, read before the next call)."""
    V = graph.poses.shape[0]
    D = 7 if use_sim3 else 6
    dtype = graph.poses.dtype
    dev = graph.poses.device
    free = (graph.valid & (~graph.fixed)).to(dtype)

    log_fn = lie.sim3_log if use_sim3 else lie.se3_log
    exp_fn = lie.sim3_exp if use_sim3 else lie.se3_exp
    inv_fn = lie.sim3_inverse if use_sim3 else lie.se3_inverse
    adj_fn = sim3_adjoint if use_sim3 else _se3_adjoint

    edge_T_inv = inv_fn(graph.edge_T)
    i = torch.clamp(graph.edge_i.long(), 0, V - 1)
    j = torch.clamp(graph.edge_j.long(), 0, V - 1)
    w = torch.where(graph.edge_valid, graph.edge_weight.to(dtype),
                    torch.zeros((), dtype=dtype, device=dev))
    Oi = _one_hot(i, V, dtype)                                  # (E, V)
    Oj = _one_hot(j, V, dtype)
    eye = torch.eye(D, dtype=dtype, device=dev)
    diag = torch.arange(V, device=dev)
    # constant part of H's diagonal blocks: fixed vertices get identity,
    # every vertex the damping
    diag_add = (1.0 - free)[:, None, None] * eye + damping * eye

    def residuals(poses):
        rel = poses[j] @ inv_fn(poses[i])
        return log_fn(rel @ edge_T_inv), rel

    def cost_of(r):
        return torch.sum(w * torch.sum(r * r, dim=-1))

    r, rel = residuals(graph.poses)
    poses, cost = graph.poses, cost_of(r)
    for _ in range(iterations):
        # J wrt delta_j ~ I; wrt delta_i = -Ad(rel)
        Ji = -adj_fn(rel)
        Hii = torch.einsum("eki,e,ekl->eil", Ji, w, Ji)
        Hjj = w[:, None, None] * eye
        Hij = torch.einsum("eki,e,kl->eil", Ji, w, eye)
        gi = torch.einsum("eki,e,ek->ei", Ji, w, r)
        gj = w[:, None] * r
        H = (torch.einsum("ea,eb,eij->abij", Oi, Oi, Hii)
             + torch.einsum("ea,eb,eij->abij", Oj, Oj, Hjj)
             + torch.einsum("ea,eb,eij->abij", Oi, Oj, Hij)
             + torch.einsum("ea,eb,eji->abij", Oj, Oi, Hij))
        g = Oi.mT @ gi + Oj.mT @ gj
        H = H * free[:, None, None, None] * free[None, :, None, None]
        H[diag, diag] += diag_add
        g = g * free[:, None]

        Hd = H.transpose(1, 2).reshape(V * D, V * D)
        delta = -solve_psd(Hd, g.reshape(-1)).reshape(V, D) * free[:, None]
        new_poses = exp_fn(delta) @ poses
        if not use_sim3:
            new_poses = lie.orthonormalize(new_poses)
        r_new, rel_new = residuals(new_poses)
        new_cost = cost_of(r_new)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        r = torch.where(accept, r_new, r)
        rel = torch.where(accept, rel_new, rel)
    return poses, cost


solve_pgo = graphs.compiled(_solve_pgo,
                            static=("iterations", "use_sim3", "damping"),
                            name="pgo")


def bucket(n: int, minimum: int = 16) -> int:
    """The least power of two from ``minimum`` that holds ``n``."""
    b = minimum
    while b < n:
        b *= 2
    return b


def padded(poses: np.ndarray, fixed: np.ndarray, edge_i: np.ndarray,
           edge_j: np.ndarray, edge_T: np.ndarray,
           edge_weight: np.ndarray) -> dict:
    """A pose graph's fields as host arrays, its V vertices and E edges
    padded to ``bucket(V)`` and ``bucket(E)``: pad vertices are identity
    poses outside the graph (``valid`` False, so the solve leaves them as
    they are), pad edges copies of the first edge that count for nothing
    (``edge_valid`` False, weight 0).  The first V poses of the solve are
    the graph's; only the solve's last bits depend on the padding."""
    V, E = len(poses), len(edge_i)
    Vp, Ep = bucket(V), bucket(E)
    take = np.where(np.arange(Ep) < E, np.arange(Ep), 0)
    out = dict(poses=np.broadcast_to(np.eye(4, dtype=poses.dtype),
                                     (Vp, 4, 4)).copy(),
               fixed=np.zeros(Vp, bool), valid=np.arange(Vp) < V,
               edge_i=edge_i[take], edge_j=edge_j[take], edge_T=edge_T[take],
               edge_weight=np.where(np.arange(Ep) < E, edge_weight[take], 0),
               edge_valid=np.arange(Ep) < E)
    out["poses"][:V] = poses
    out["fixed"][:V] = fixed
    return out
