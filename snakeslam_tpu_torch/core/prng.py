"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` makes them.

Counterpart of the part of ``jax.random`` that ``snakeslam_tpu`` uses for
its RANSAC hypotheses: ``PRNGKey``, ``split`` and ``uniform``, with the
threefry2x32 implementation and ``jax_threefry_partitionable`` on (the
default of JAX 0.9: keys split and bits drawn from a 64-bit iota of the
output shape, ``jax/_src/prng.py::_threefry_split_foldlike`` and
``_threefry_random_bits_partitionable``).

Threefry is integer arithmetic, so the words are the same on every device.
They are computed in int64 tensors masked to 32 bits (torch's ``uint32``
support is partial) on the device that the draw is for, the CPU included.
A key is a host pair of 32-bit words (numpy ``uint32``, shape (2,));
splitting it is host work on a few words.

``sample_without_replacement`` gives the indices that the JAX package's
Gumbel top-k draws give (``top_k(where(mask, 0, -inf) - log(-log(u)), k)``).
The Gumbel transform is monotone and every valid logit is 0, so the indices
are the top k of ``where(mask, u, -1)`` with ties to the lower index: exact
comparisons, no transcendental function, the same indices on every device.

Draw dtype: JAX's ``uniform`` draws the default float, float64 under
``jax_enable_x64`` and float32 otherwise, and without that flag a seed
keeps only its low 32 bits.  ``enable_x64`` (or the ``x64`` context
manager) mirrors that flag's effect on keys and draws here, and nothing
else; the default is off (float32).

XLA on the CPU scales the uniforms with a fused multiply-add; ``_fma``
reproduces its rounding from error-free transformations, so the float64
draws match bit for bit too.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_X64 = False


def enable_x64(flag: bool = True) -> None:
    """Draw float64 uniforms from now on (``jax_enable_x64``'s effect on
    ``jax.random.uniform``'s default dtype), or float32 with ``False``."""
    global _X64
    _X64 = bool(flag)


@contextlib.contextmanager
def x64(flag: bool = True):
    """``enable_x64(flag)`` inside the block, the previous setting after."""
    prev = _X64
    enable_x64(flag)
    try:
        yield
    finally:
        enable_x64(prev)


def draw_dtype() -> torch.dtype:
    """The float dtype ``uniform`` draws by default."""
    return torch.float64 if _X64 else torch.float32


# ---------------------------------------------------------------------------
# threefry2x32 on 32-bit words held in int64 tensors
# ---------------------------------------------------------------------------

def _add(a, b):
    return (a + b) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The 20-round Threefry-2x32 hash of the count words ``(x1, x2)`` (int64
    tensors holding 32-bit words) under the key ``(k1, k2)``; returns the two
    output words in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = _add(x1, ks[0]), _add(x2, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = _add(x1, x2)
            x2 = x1 ^ _rotl(x2, r)
        x1 = _add(x1, ks[(i + 1) % 3])
        x2 = _add(x2, (ks[(i + 2) % 3] + i + 1) & _M32)
    return x1, x2


def _hash(key, shape, device):
    """threefry2x32 of a 64-bit row-major iota of ``shape`` (its high and
    low words), as int64 tensors on ``device``."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    n = int(np.prod(shape, dtype=np.int64))
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return threefry2x32(int(k[0]), int(k[1]), counts >> 32, counts & _M32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's 64 bits as (high, low), or
    (0, its low 32 bits) with x64 off."""
    s = int(seed) & (0xFFFFFFFFFFFFFFFF if _X64 else _M32)
    return np.array([s >> 32, s & _M32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    return torch.stack(_hash(key, (num,), "cpu"), dim=1).numpy().astype(
        np.uint32)


def random_bits(key, shape, width: int = 32, device="cpu") -> torch.Tensor:
    """``jax.random.bits``' words as int64: 32-bit words in [0, 2**32), or
    64-bit words as their two's-complement bit pattern."""
    if width not in (32, 64):
        raise ValueError(f"width must be 32 or 64, got {width}")
    b1, b2 = _hash(key, tuple(shape), device)
    if width == 32:
        return b1 ^ b2
    return (torch.where(b1 >= 2**31, b1 - 2**32, b1) << 32) | b2


# ---------------------------------------------------------------------------
# a correctly rounded a * b + c without a fused instruction
# ---------------------------------------------------------------------------

def _is_f32(a: torch.Tensor) -> bool:
    return a.dtype == torch.float32


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e) with p + e = a * b exactly (Dekker, Veltkamp splitting)."""
    split_at = 4097.0 if _is_f32(a) else 134217729.0
    p = a * b

    def halves(x):
        c = x * split_at
        hi = c - (c - x)
        return hi, x - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd_sum(a, b):
    """a + b rounded to odd: exact sums stay, inexact ones take the
    neighbour whose last mantissa bit is 1."""
    s, err = _two_sum(a, b)
    even = (s.view(torch.int32 if _is_f32(s) else torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    away = torch.nextafter(s, torch.copysign(inf, err))
    return torch.where((err != 0) & even, away, s)


def _fma(a, b, c):
    """round(a * b + c) with one rounding (Boldo and Melquiond, emulation
    of the FMA by rounding to odd)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_odd_sum(tl, ul)


def _unit_floats(b1, b2, f32: bool):
    """[0, 1) floats from the words: the high mantissa bits of one in
    [1, 2), minus 1 (32 bits of ``b1 ^ b2``, or 52 of ``b1 << 32 | b2``)."""
    if f32:
        ones = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
        return ones.view(torch.float32) - 1.0
    # (b1 << 32 | b2) >> 12 without leaving the int64 range
    ones = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
    return ones.view(torch.float64) - 1.0


def uniform(key, shape, dtype: torch.dtype | None = None,
            minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform``: the mantissa of ``[1, 2)`` filled with the
    high bits of the words, minus 1, scaled into ``[minval, maxval)``."""
    dtype = dtype or draw_dtype()
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"uniform draws float32 or float64, not {dtype}")
    f32 = dtype == torch.float32
    floats = _unit_floats(*_hash(key, tuple(shape), device), f32)
    # minval and maxval - minval rounded to the dtype on the host; filled,
    # not copied, onto a device (a copy would synchronize)
    np_dtype = np.float32 if f32 else np.float64
    lo = np_dtype(minval)
    span = np_dtype(maxval) - lo
    lo_a = torch.full_like(floats, float(lo))
    return torch.maximum(
        lo_a, _fma(floats, torch.full_like(floats, float(span)), lo_a))


def sample_without_replacement(key, mask: torch.Tensor, n_hypotheses: int,
                               k: int,
                               dtype: torch.dtype | None = None
                               ) -> torch.Tensor:
    """(n_hypotheses, k) int64 indices on the mask's device: for each row,
    the k largest of ``uniform(key, (n_hypotheses, N), minval=1e-9)`` over
    the valid entries, in descending order, ties to the lower index (the
    JAX package's Gumbel top-k: its draws at the same key)."""
    u = uniform(key, (n_hypotheses, mask.shape[0]), dtype, 1e-9, 1.0,
                mask.device)
    scores = torch.where(mask[None, :], u, torch.full_like(u, -1.0))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[:, :k].contiguous()
