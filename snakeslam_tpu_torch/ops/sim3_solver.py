"""Sim3/SE3 registration RANSAC from 3D-3D correspondences.

Counterpart of ``snakeslam_tpu/ops/sim3_solver.py`` (the reference's
RegistrationProjectRANSAC in loop-closure verification): batched minimal
Umeyama hypotheses over matched map-point pairs, their sample indices
drawn by the caller (``core/prng.py``: as the JAX function draws them),
scored by 3D consistency, then polished twice on the inlier set.  Nothing
in here reads a device value on the host: the caller fetches the result in
one copy.
"""

from __future__ import annotations

import torch

from snakeslam_tpu_torch.ops.linalg import svd3x3


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
            with_scale: bool = True):
    """Weighted Umeyama alignment dst ~ s R src + t, batched over leading
    dims: src, dst (..., N, 3), weights (..., N) >= 0.

    Returns (s (...,), R (..., 3, 3), t (..., 3)).  The rotation takes the
    determinant fix R = U diag(1, 1, det(U) det(Vt)) Vt (``svd3x3``'s U is
    right-handed, so the fix reads det(Vt))."""
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-9)
    mu_s = torch.einsum("...n,...ni->...i", w, src)
    mu_d = torch.einsum("...n,...ni->...i", w, dst)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, xd, xs)
    U, D, Vt = svd3x3(cov)
    # det(Vt) as the triple product of its rows (no solver library call)
    d = torch.sign(torch.sum(
        Vt[..., 0, :] * torch.linalg.cross(Vt[..., 1, :], Vt[..., 2, :],
                                           dim=-1), dim=-1))
    S = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        var_s = torch.einsum("...n,...ni,...ni->...", w, xs, xs)
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(R.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def sim3_ransac(
    src: torch.Tensor,          # (N, 3) points in the source frame
    dst: torch.Tensor,          # (N, 3) corresponding points in the target
    mask: torch.Tensor,         # (N,) bool
    sample_idx: torch.Tensor,   # (H, 3) hypotheses' pairs, on the device
    threshold: float = 0.1,     # 3D consistency threshold (target units)
    with_scale: bool = True,
):
    """Returns (s, R, t, inlier_mask, n_inliers) with dst ~ s R src + t, all
    device tensors."""
    ones = torch.ones(sample_idx.shape, dtype=src.dtype, device=src.device)
    s_h, R_h, t_h = umeyama(src[sample_idx], dst[sample_idx], ones,
                            with_scale=with_scale)
    pred = s_h[:, None, None] * torch.einsum("hij,nj->hni", R_h, src) \
        + t_h[:, None, :]
    err = torch.linalg.norm(pred - dst[None], dim=-1)
    inl = (err < threshold) & mask[None, :]
    # index_select with the device index: indexing by a 0-d tensor would
    # read it on the host
    best = torch.argmax(inl.sum(dim=1)).view(1)
    s, R, t, inliers = (x.index_select(0, best)[0]
                        for x in (s_h, R_h, t_h, inl))

    # polish on the inlier set (2 rounds)
    for _ in range(2):
        s, R, t = umeyama(src, dst, inliers.to(src.dtype),
                          with_scale=with_scale)
        err = torch.linalg.norm(s * (src @ R.T) + t - dst, dim=-1)
        inliers = (err < threshold) & mask
    return s, R, t, inliers, inliers.sum()
