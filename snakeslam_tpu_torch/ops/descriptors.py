"""ORB descriptor bit manipulation and Hamming distances on tensors.

Counterpart of ``snakeslam_tpu/ops/descriptors.py``.  Descriptors are stored
packed as (N, 32) uint8 (256 bits) and unpacked to (N, 256) {0,1} planes on
the device; the pairwise Hamming matrix is then one matrix product,

    popcount(a ^ b) = sum(a) + sum(b) - 2 * dot(a, b)   for bits in {0,1},

computed in float32 with TF32 off (the package sets that policy at import),
so every partial sum is an integer <= 256 and the result is exact.
"""

from __future__ import annotations

import numpy as np
import torch

DESC_BITS = 256
DESC_BYTES = 32


def unpack_bits_np(packed: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 256) uint8 in {0,1} (host-side)."""
    return np.unpackbits(packed.astype(np.uint8), axis=-1, bitorder="little")


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (N, 32) uint8 (host-side)."""
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) uint8 in {0,1} (device-side)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (DESC_BITS,))


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances (N, 256) x (M, 256) -> (N, M) int32."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    dot = a @ b.T
    wa = a.sum(dim=-1)
    wb = b.sum(dim=-1)
    return (wa[:, None] + wb[None, :] - 2.0 * dot).to(torch.int32)


def hamming_distance(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between aligned (..., 256) bit planes."""
    return torch.sum(bits_a != bits_b, dim=-1, dtype=torch.int32)


def hamming_np(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """Host oracle: pairwise Hamming on packed (N,32)/(M,32) uint8."""
    a = unpack_bits_np(a_packed)
    b = unpack_bits_np(b_packed)
    return (a[:, None, :] != b[None, :, :]).sum(axis=-1)
