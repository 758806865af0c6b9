"""Fused robust pose refine: the CUDA kernel, its plain version, its wrapper.

Counterpart of ``snakeslam_tpu/ops/pose_pallas.py`` (``pose_refine_fused``):
a whole robust pose refine — ``outer_iters`` rounds of (``inner_iters``
damped GN steps -> chi2 outlier reclassification) — in one launch.  The
kernel is hand-written CUDA C++ for ``sm_90a`` (``csrc/pose_refine.cu``),
compiled with ``nvcc`` at first use into ``snakeslam_tpu_torch/build/`` and
bound with ``ctypes``; the source file documents its design.

``pose_refine_fused`` takes the JAX signature.  CUDA tensors launch the
kernel; CPU tensors take ``pose_refine_fused_reference``, the plain PyTorch
version with the same semantics.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import time
from pathlib import Path

import torch

from snakeslam_tpu_torch.core import lie
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.ops.linalg import solve6x6_psd

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pose_refine.cu"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libpose_refine.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = 0      # kernel launches since the last reset (wrapper count)
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def build(force: bool = False) -> float:
    """Compile ``csrc/pose_refine.cu`` into ``build/libpose_refine.so``;
    returns the seconds the build took (0.0 when an up-to-date library was
    already there and ``force`` is False)."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True)
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        fn = lib.snk_pose_refine_fused
        fn.argtypes = ([ctypes.c_void_p] * 11
                       + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain version (CPU path, and the oracle the kernel is held against)
# ---------------------------------------------------------------------------

def _se3_exp_fused(v: torch.Tensor, w: torch.Tensor):
    """(B, 3), (B, 3) -> R (B, 3, 3), t (B, 3); the kernel's exponential
    (Taylor switch at theta < 1e-4)."""
    th2 = torch.sum(w * w, dim=-1)
    th = torch.sqrt(th2 + 1e-30)
    small = th < 1e-4
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    bb = torch.where(small, 0.5 - th2 / 24.0,
                     (1.0 - torch.cos(th)) / (th2 + 1e-30))
    cc = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                     (th - torch.sin(th)) / (th2 * th + 1e-30))
    W = lie.hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + a[:, None, None] * W + bb[:, None, None] * W2
    V = eye + bb[:, None, None] * W + cc[:, None, None] * W2
    return R, (V @ v[..., None])[..., 0]


def _gram_schmidt(R: torch.Tensor) -> torch.Tensor:
    """Column-wise modified Gram-Schmidt of (B, 3, 3)."""
    c0 = R[..., :, 0]
    c0 = c0 * torch.rsqrt(torch.sum(c0 * c0, dim=-1, keepdim=True) + 1e-30)
    c1 = R[..., :, 1]
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 * torch.rsqrt(torch.sum(c1 * c1, dim=-1, keepdim=True) + 1e-30)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1)


def pose_refine_fused_reference(T_init, points, uv, right, weight, mask,
                                cam: Pinhole, bf,
                                chi2_mono: float = 2.1 ** 2,
                                chi2_stereo: float = 2.3 ** 2,
                                outer_iters: int = 2, inner_iters: int = 2,
                                damping: float = 1e-5):
    """Plain PyTorch version of the kernel on batched (B, N) problems:
    T_init (B, 4, 4), points (B, N, 3), uv (B, N, 2), right / weight / mask
    (B, N).  Returns (T (B, 4, 4), inlier (B, N) bool, n_inliers (B,) int32).
    """
    f32 = torch.float32
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    uo, vo = uv[..., 0], uv[..., 1]
    ro = right.to(f32)
    w2 = weight.to(f32) ** 2
    msk = mask.to(torch.bool)
    has_stereo = ro > 0.0
    sflag = has_stereo.to(f32)
    delta_h = torch.where(has_stereo, math.sqrt(chi2_stereo),
                          math.sqrt(chi2_mono))
    th_cls = torch.where(has_stereo, chi2_stereo, chi2_mono)
    fx, fy, cx, cy = cam
    R = T_init[:, :3, :3].to(f32)
    t = T_init[:, :3, 3].to(f32)

    def residuals(R, t):
        def row(k):
            return (R[:, k, 0, None] * px + R[:, k, 1, None] * py
                    + R[:, k, 2, None] * pz + t[:, k, None])
        X, Y, Z = row(0), row(1), row(2)
        z_ok = Z > 1e-4
        iz = 1.0 / torch.where(z_ok, Z, torch.ones_like(Z))
        u = fx * X * iz + cx
        v = fy * Y * iz + cy
        ru = u - uo
        rv = v - vo
        rr = torch.where(has_stereo, u - bf * iz - ro, torch.zeros_like(u))
        chi2 = w2 * (ru * ru + rv * rv + rr * rr)
        return X, Y, Z, z_ok, iz, ru, rv, rr, chi2

    eye6 = torch.eye(6, dtype=f32, device=T_init.device)

    def gn_step(R, t, inlier):
        X, Y, Z, z_ok, iz, ru, rv, rr, chi2 = residuals(R, t)
        iz2 = iz * iz
        e = torch.sqrt(chi2 + 1e-12)
        huber = torch.clamp(delta_h / e, max=1.0)
        wt = torch.where(msk & z_ok & inlier, w2 * huber, torch.zeros_like(e))
        zero = torch.zeros_like(iz)
        # raw Z (not the clamped one) in the hat-block terms
        j0 = torch.stack([fx * iz, zero, -fx * X * iz2, -fx * X * Y * iz2,
                          fx * Z * iz + fx * X * X * iz2, -fx * Y * iz], -1)
        j1 = torch.stack([zero, fy * iz, -fy * Y * iz2,
                          -fy * Z * iz - fy * Y * Y * iz2, fy * X * Y * iz2,
                          fy * X * iz], -1)
        j2 = sflag[..., None] * torch.stack(
            [fx * iz, zero, (bf - fx * X) * iz2, (bf - fx * X) * Y * iz2,
             fx * Z * iz + (fx * X - bf) * X * iz2, -fx * Y * iz], -1)
        J = torch.stack([j0, j1, j2], dim=-2)            # (B, N, 3, 6)
        r = torch.stack([ru, rv, rr], dim=-1)            # (B, N, 3)
        H = torch.einsum("bnki,bn,bnkj->bij", J, wt, J) + damping * eye6
        b = torch.einsum("bnki,bn,bnk->bi", J, wt, r)
        d = solve6x6_psd(H, b)
        Rd, td = _se3_exp_fused(-d[:, :3], -d[:, 3:])
        return Rd @ R, (Rd @ t[..., None])[..., 0] + td

    inlier = msk
    for _ in range(outer_iters):
        for _ in range(inner_iters):
            R, t = gn_step(R, t, inlier)
        _, _, _, z_ok, _, _, _, _, chi2 = residuals(R, t)
        inlier = msk & z_ok & (chi2 <= th_cls)
    T = lie.se3(_gram_schmidt(R), t)
    return T, inlier, inlier.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _launch(T_init, points, uv, right, weight, mask, cam, bf, chi2_mono,
            chi2_stereo, outer_iters, inner_iters, damping):
    global LAUNCHES
    B, N = points.shape[:2]
    f32 = torch.float32
    for name, t in (("T_init", T_init), ("points", points), ("uv", uv),
                    ("right", right), ("weight", weight), ("cam.fx", cam.fx),
                    ("cam.fy", cam.fy), ("cam.cx", cam.cx),
                    ("cam.cy", cam.cy), ("bf", bf)):
        if t.dtype != f32:
            raise TypeError(f"pose_refine_fused: {name} must be float32, "
                            f"got {t.dtype}")
    for name, t, shape in (("T_init", T_init, (B, 4, 4)),
                           ("uv", uv, (B, N, 2)), ("right", right, (B, N)),
                           ("weight", weight, (B, N)), ("mask", mask, (B, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"pose_refine_fused: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, t in (("cam.fx", cam.fx), ("cam.fy", cam.fy),
                    ("cam.cx", cam.cx), ("cam.cy", cam.cy), ("bf", bf)):
        if t.numel() != 1:
            raise ValueError(f"pose_refine_fused: {name} must be a scalar")
    T_init = T_init.contiguous()
    points = points.contiguous()
    uv = uv.contiguous()
    right = right.contiguous()
    weight = weight.contiguous()
    mask_u8 = mask.to(torch.bool).contiguous().view(torch.uint8)
    scal = [t.contiguous() for t in (cam.fx, cam.fy, cam.cx, cam.cy, bf)]
    T_out = torch.empty((B, 4, 4), dtype=f32, device=points.device)
    inl = torch.empty((B, N), dtype=torch.bool, device=points.device)
    n_inl = torch.empty((B,), dtype=torch.int32, device=points.device)
    lib = _load()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.snk_pose_refine_fused(
        T_init.data_ptr(), points.data_ptr(), uv.data_ptr(),
        right.data_ptr(), weight.data_ptr(), mask_u8.data_ptr(),
        *[s.data_ptr() for s in scal],
        float(chi2_mono), float(chi2_stereo), float(damping),
        int(outer_iters), int(inner_iters), int(B), int(N),
        T_out.data_ptr(), inl.view(torch.uint8).data_ptr(),
        n_inl.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pose_refine_fused: CUDA error {err} at launch")
    LAUNCHES += 1
    return T_out, inl, n_inl


def pose_refine_fused(T_init, points, uv, right, weight, mask,
                      cam: Pinhole, bf,
                      chi2_mono: float = 2.1 ** 2,
                      chi2_stereo: float = 2.3 ** 2,
                      outer_iters: int = 2, inner_iters: int = 2,
                      damping: float = 1e-5):
    """One-launch robust pose refine.  Returns (T, inlier_mask, n_inliers).

    Unbatched: T_init (4, 4), points (N, 3), uv (N, 2), right / weight /
    mask (N,).  Batched: the same with a leading B.  ``cam`` fields and
    ``bf`` are 0-d float32 tensors on the same device.  CUDA tensors launch
    the kernel, CPU tensors take the plain version; mixed devices raise.
    """
    tensors = (T_init, points, uv, right, weight, mask, *cam, bf)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"pose_refine_fused: tensors on mixed devices "
                         f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    batched = points.dim() == 3
    if not batched:
        T_init, points, uv, right, weight, mask = (
            t[None] for t in (T_init, points, uv, right, weight, mask))
    args = (T_init, points, uv, right, weight, mask, cam, bf, chi2_mono,
            chi2_stereo, outer_iters, inner_iters, damping)
    if device.type == "cuda":
        T, inl, n = _launch(*args)
    elif device.type == "cpu":
        T, inl, n = pose_refine_fused_reference(*args)
    else:
        raise ValueError(f"pose_refine_fused: unsupported device {device}")
    if not batched:
        return T[0], inl[0], n[0]
    return T, inl, n
