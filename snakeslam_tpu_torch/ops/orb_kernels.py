"""FAST-16 and the tile-unit patch gather: CUDA kernels, plain versions,
wrappers.

Counterpart of ``snakeslam_tpu/ops/orb_pallas.py``.  Both kernels are
hand-written CUDA C++ for ``sm_90a`` (``csrc/fast_score.cu``,
``csrc/patch_gather.cu``), built at first launch by ``utils/cuda_build.py``
and bound with ``ctypes``; the sources document their design.

CUDA tensors launch the kernel; CPU tensors take the plain version in this
module.  There is no fallback: a failed build or launch raises.
``FAST_LAUNCHES`` and ``PATCH_LAUNCHES`` count kernel launches through
``graphs.count``: a launch captured into a CUDA graph (the ORB programs of
``ops/orb.py``) counts once for every replay of that graph.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from snakeslam_tpu_torch.ops.orb import FAST_RING
from snakeslam_tpu_torch.utils import cuda_build, graphs

FAST_SOURCE = "fast_score.cu"
PATCH_SOURCE = "patch_gather.cu"
FAST_LAUNCHES = 0     # kernel launches since the last reset (graph
PATCH_LAUNCHES = 0    # replays count the launches they hold)
_COUNT_LOCK = threading.Lock()   # async mode launches from two threads
_MAX_GRID_YZ = 65535
FAST_TILE_Y = 16      # output rows of one FAST block (csrc/fast_score.cu)


def _bind_fast(lib):
    fn = lib.snk_fast_score
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int


def _bind_patch(lib):
    fn = lib.snk_patch_gather
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int


def _device_of(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on mixed devices "
                         f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


# ---------------------------------------------------------------------------
# FAST-16
# ---------------------------------------------------------------------------

def _arc9(bits: torch.Tensor) -> torch.Tensor:
    """9 contiguous set bits on the 16-bit ring (doubled so that rotation
    is a shift)."""
    m = bits | (bits << 16)
    acc = m
    for k in range(1, 9):
        acc = acc & (m >> k)
    return (acc & 0xFFFF) != 0


def fast_score_batch_reference(imgs: torch.Tensor, threshold: float = 20.0):
    """Plain version of the FAST kernel: (B, H, W) -> (score (B, H, W)
    float32, corner (B, H, W) bool), borders (3 px) zeroed per image.

    Sums in ``FAST_RING`` order k = 0..15, as the kernel does, so the two
    agree bit for bit on any input."""
    imgs = imgs.to(torch.float32)
    B, H, W = imgs.shape
    i32 = torch.int32
    bits_b = torch.zeros(imgs.shape, dtype=i32, device=imgs.device)
    bits_d = torch.zeros_like(bits_b)
    sum_b = torch.zeros_like(imgs)
    sum_d = torch.zeros_like(imgs)
    zero = torch.zeros((), dtype=torch.float32, device=imgs.device)
    for k, (dx, dy) in enumerate(FAST_RING):
        # ring values that wrap around the image only reach the border,
        # which is masked below
        ring = torch.roll(imgs, shifts=(-int(dy), -int(dx)), dims=(1, 2))
        bright = ring > imgs + threshold
        dark = ring < imgs - threshold
        bits_b = bits_b | (bright.to(i32) << k)
        bits_d = bits_d | (dark.to(i32) << k)
        sum_b = sum_b + torch.where(bright, ring - imgs - threshold, zero)
        sum_d = sum_d + torch.where(dark, imgs - ring - threshold, zero)
    yy = torch.arange(H, device=imgs.device)[:, None]
    xx = torch.arange(W, device=imgs.device)[None, :]
    border = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    corner = (_arc9(bits_b) | _arc9(bits_d)) & border
    score = torch.where(corner, torch.maximum(sum_b, sum_d), zero)
    return score, corner


def _count_fast(n: int):
    global FAST_LAUNCHES
    with _COUNT_LOCK:
        FAST_LAUNCHES += n


def _count_patch(n: int):
    global PATCH_LAUNCHES
    with _COUNT_LOCK:
        PATCH_LAUNCHES += n


def _launch_fast(imgs: torch.Tensor, threshold: float):
    B, H, W = imgs.shape
    if B > _MAX_GRID_YZ or -(-H // FAST_TILE_Y) > _MAX_GRID_YZ:
        raise ValueError(f"fast_score_batch: batch {B} x height {H} exceeds "
                         "the kernel's grid")
    score = torch.empty((B, H, W), dtype=torch.float32, device=imgs.device)
    corner = torch.empty((B, H, W), dtype=torch.bool, device=imgs.device)
    lib = cuda_build.load(FAST_SOURCE, _bind_fast)
    stream = cuda_build.raw_stream(imgs)
    err = lib.snk_fast_score(imgs.data_ptr(), B, H, W, float(threshold),
                             score.data_ptr(),
                             corner.view(torch.uint8).data_ptr(), stream)
    cuda_build.check_launch(err, "fast_score_batch")
    graphs.count(_count_fast)
    return score, corner


def fast_score_batch(imgs: torch.Tensor, threshold: float = 20.0):
    """Batched FAST: (B, H, W) images -> (B, H, W) float32 scores + bool
    corner masks, in one launch for the whole batch.  Matches
    ``snakeslam_tpu/ops/orb_pallas.py::fast_score_pallas_batch``."""
    if imgs.dim() != 3:
        raise ValueError(f"fast_score_batch: expected (B, H, W), got "
                         f"{tuple(imgs.shape)}")
    device = _device_of("fast_score_batch", imgs)
    imgs = imgs.to(torch.float32).contiguous()
    if device.type == "cuda":
        return _launch_fast(imgs, threshold)
    return fast_score_batch_reference(imgs, threshold)


# ---------------------------------------------------------------------------
# patch gather
# ---------------------------------------------------------------------------

def patch_gather_reference(imgs: torch.Tensor, y_tile: torch.Tensor,
                           x_tile: torch.Tensor, size_y: int,
                           size_x: int = 256) -> torch.Tensor:
    """Plain version of the gather kernel: block (b, i) is the slice
    ``imgs[b, y*8 : y*8 + size_y, x*128 : x*128 + size_x]`` with
    (y, x) = (y_tile[b, i], x_tile[b, i]), as one index gather."""
    B = imgs.shape[0]
    dev = imgs.device
    rows = y_tile.long()[..., None] * 8 + torch.arange(size_y, device=dev)
    cols = x_tile.long()[..., None] * 128 + torch.arange(size_x, device=dev)
    b = torch.arange(B, device=dev)[:, None, None, None]
    return imgs.to(torch.float32)[b, rows[..., :, None], cols[..., None, :]]


def _launch_patch(imgs, y_tile, x_tile, size_y, size_x):
    B, H, W = imgs.shape
    N = y_tile.shape[1]
    out = torch.empty((B, N, size_y, size_x), dtype=torch.float32,
                      device=imgs.device)
    if B * N == 0:
        return out
    if B > _MAX_GRID_YZ:
        raise ValueError(f"patch_gather: batch {B} exceeds the kernel's grid")
    # 16-byte vector loads need every block row 16-byte aligned
    vec = int(W % 4 == 0 and imgs.data_ptr() % 16 == 0)
    lib = cuda_build.load(PATCH_SOURCE, _bind_patch)
    stream = cuda_build.raw_stream(imgs)
    err = lib.snk_patch_gather(imgs.data_ptr(), y_tile.data_ptr(),
                               x_tile.data_ptr(), B, H, W, N, size_y, size_x,
                               vec, out.data_ptr(), stream)
    cuda_build.check_launch(err, "patch_gather")
    graphs.count(_count_patch)
    return out


def patch_gather(imgs: torch.Tensor, y_tile: torch.Tensor,
                 x_tile: torch.Tensor, size_y: int,
                 size_x: int = 256) -> torch.Tensor:
    """(B, H, W) images + (B, N) int32 tile corners -> (B, N, size_y,
    size_x) float32 blocks.  Offsets are in tile units (rows of 8, columns
    of 128) and sizes multiples of (8, 128), the API of
    ``snakeslam_tpu/ops/orb_pallas.py::patch_gather_pallas``.  Blocks that
    would leave the image raise (the Pallas version leaves that to its
    callers)."""
    if size_y % 8 or size_x % 128 or size_y <= 0 or size_x <= 0:
        raise ValueError(f"patch_gather: sizes ({size_y}, {size_x}) must be "
                         "positive multiples of (8, 128)")
    if imgs.dim() != 3 or y_tile.dim() != 2 or y_tile.shape != x_tile.shape \
            or y_tile.shape[0] != imgs.shape[0]:
        raise ValueError(f"patch_gather: expected (B, H, W) images and (B, N)"
                         f" tiles, got {tuple(imgs.shape)}, "
                         f"{tuple(y_tile.shape)}, {tuple(x_tile.shape)}")
    if y_tile.dtype.is_floating_point or x_tile.dtype.is_floating_point:
        raise TypeError("patch_gather: tile offsets must be integers")
    device = _device_of("patch_gather", imgs, y_tile, x_tile)
    _, H, W = imgs.shape
    if y_tile.numel() and bool(
            (y_tile.min() < 0) | (x_tile.min() < 0)
            | (y_tile.max().long() * 8 + size_y > H)
            | (x_tile.max().long() * 128 + size_x > W)):
        raise ValueError(f"patch_gather: a ({size_y}, {size_x}) block "
                         f"leaves the ({H}, {W}) image")
    imgs = imgs.to(torch.float32).contiguous()
    if device.type == "cuda":
        return _launch_patch(imgs, y_tile.to(torch.int32).contiguous(),
                             x_tile.to(torch.int32).contiguous(), size_y,
                             size_x)
    return patch_gather_reference(imgs, y_tile, x_tile, size_y, size_x)
