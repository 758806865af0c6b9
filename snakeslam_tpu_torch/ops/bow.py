"""Bag-of-binary-words: vocabulary training, transform, and scoring.

Counterpart of ``snakeslam_tpu/ops/bow.py`` (the reference's MiniBow2
vocabulary).  The vocabulary is a flattened complete k-ary tree of binary
cluster centres held in numpy; the tree descent is batched (every
descriptor compares with its node's k children at once and takes the
argmin).  BoW vectors are dense (n_words,) tf-idf arrays, L1-normalized.

The per-keyframe vectors of the keyframe database are computed on the host
(``transform_packed_np``: XOR + popcount over 4 uint64 lanes, ~2 MFLOP per
keyframe); ``transform`` is the same descent on tensors, against a device
copy of the tree built at its first use on a device.  The numpy-side packed
tree and the device copies are cached keyed on the node array object (the
cache holds the array itself, so a recycled ``id`` can never serve another
vocabulary's tree).

The shipped vocabulary (``data/orbvoc_synth.npz``) is the JAX package's
file, trained on ORB descriptors of rendered synthetic scenes.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch


class Vocabulary(NamedTuple):
    """Flattened complete k-ary tree of binary cluster centres.

    node_bits[0] is the root (unused for matching); level l occupies
    k^1 + ... + k^l slots; leaves (words) are the last k^L nodes."""

    node_bits: np.ndarray  # (n_nodes, 256) int8 cluster centres
    k: int
    levels: int
    n_words: int
    idf: np.ndarray        # (n_words,) float32 inverse document frequency


def _kmedians_binary(bits: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians (majority-vote centres, Hamming assignment)."""
    n = len(bits)
    if n <= k:
        centers = np.zeros((k, bits.shape[1]), dtype=np.int8)
        centers[:n] = bits
        assign = np.arange(n) % k
        return centers, assign
    centers = bits[rng.choice(n, k, replace=False)].astype(np.int8)
    for _ in range(iters):
        d = (bits[:, None, :] != centers[None, :, :]).sum(axis=2)
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = assign == c
            if sel.any():
                centers[c] = (bits[sel].mean(axis=0) > 0.5).astype(np.int8)
            else:
                centers[c] = bits[rng.integers(n)]
    return centers, assign


def train_vocabulary(descriptors_bits: np.ndarray, k: int = 10,
                     levels: int = 3, seed: int = 0) -> Vocabulary:
    """Hierarchical k-medians over (N, 256) {0,1} descriptors."""
    rng = np.random.default_rng(seed)
    n_nodes = sum(k**l for l in range(1, levels + 1)) + 1
    node_bits = np.zeros((n_nodes, descriptors_bits.shape[1]), dtype=np.int8)

    # BFS: node 0 = root holding all descriptors
    groups = {0: descriptors_bits}
    next_slot = 1
    for _ in range(levels):
        new_groups = {}
        for _, data in sorted(groups.items()):
            centers, assign = _kmedians_binary(data, k, rng)
            for c in range(k):
                node_bits[next_slot] = centers[c]
                new_groups[next_slot] = data[assign == c]
                next_slot += 1
        groups = new_groups

    n_words = k**levels
    # idf from the training set occupancy
    counts = np.array(
        [max(len(groups.get(next_slot - n_words + w, [])), 1)
         for w in range(n_words)],
        dtype=np.float64,
    )
    idf = np.log(len(descriptors_bits) / counts).astype(np.float32)
    idf = np.maximum(idf, 0.1)
    return Vocabulary(node_bits=node_bits, k=k, levels=levels,
                      n_words=n_words, idf=idf)


def save_vocabulary(voc: Vocabulary, path):
    np.savez_compressed(path, node_bits=voc.node_bits, k=voc.k,
                        levels=voc.levels, n_words=voc.n_words, idf=voc.idf)


def load_vocabulary(path) -> Vocabulary:
    z = np.load(path)
    return Vocabulary(node_bits=z["node_bits"], k=int(z["k"]),
                      levels=int(z["levels"]), n_words=int(z["n_words"]),
                      idf=z["idf"])


_VOC_FILE_CACHE: dict = {}
_RANDOM_VOC_CACHE: dict = {}


def random_vocabulary_cached(seed: int) -> Vocabulary:
    """Fallback vocabulary trained on uniform random bits (used only when
    no vocabulary file is available); cached per seed.  k=10, levels=4 ->
    10k words, far above the per-frame feature count."""
    voc = _RANDOM_VOC_CACHE.get(seed)
    if voc is None:
        rng = np.random.default_rng(seed + 1)
        train = rng.integers(0, 2, size=(30000, 256)).astype(np.int8)
        voc = train_vocabulary(train, k=10, levels=4, seed=seed)
        _RANDOM_VOC_CACHE.clear()
        _RANDOM_VOC_CACHE[seed] = voc
    return voc


def load_vocabulary_cached(path) -> Vocabulary:
    """Process-wide vocabulary cache keyed on (path, mtime): repeated
    SlamSystem constructions share one loaded tree."""
    key = (str(path), os.path.getmtime(path))
    voc = _VOC_FILE_CACHE.get(key)
    if voc is None:
        voc = load_vocabulary(path)
        _VOC_FILE_CACHE.clear()
        _VOC_FILE_CACHE[key] = voc
    return voc


# ---------------------------------------------------------------------------
# caches keyed on the node array object: entry[0] is the array itself
# ---------------------------------------------------------------------------

_PACKED_VOC_CACHE: dict = {}
_DEVICE_VOC_CACHE: dict = {}


def _packed_tree(voc: Vocabulary) -> np.ndarray:
    """The tree's centres packed into (n_nodes, 4) uint64 lanes."""
    cached = _PACKED_VOC_CACHE.get(id(voc.node_bits))
    if cached is None or cached[0] is not voc.node_bits:
        packed = np.packbits(voc.node_bits.astype(np.uint8), axis=-1,
                             bitorder="little")
        cached = (voc.node_bits, np.ascontiguousarray(packed).view(np.uint64))
        _PACKED_VOC_CACHE.clear()
        _PACKED_VOC_CACHE[id(voc.node_bits)] = cached
    return cached[1]


def device_tree(voc: Vocabulary, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(node_bits (n_nodes, 256) float32 {0,1}, idf (n_words,) float32) on
    ``device``, uploaded once per vocabulary and device."""
    device = torch.device(device)
    key = (id(voc.node_bits), str(device))
    cached = _DEVICE_VOC_CACHE.get(key)
    if cached is None or cached[0] is not voc.node_bits:
        cached = (voc.node_bits,
                  torch.from_numpy(voc.node_bits.astype(np.float32)).to(device),
                  torch.from_numpy(np.asarray(voc.idf, np.float32)).to(device))
        _DEVICE_VOC_CACHE[key] = cached
    return cached[1], cached[2]


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def transform(voc: Vocabulary, desc_bits: torch.Tensor, valid: torch.Tensor):
    """Descriptors (N, 256) {0,1} -> (word ids (N,) int32, dense
    L1-normalized BoW vector (n_words,) float32), on the descriptors'
    device.  Hamming distances are float32 matrix products of {0,1}
    planes (exact: every partial sum is an integer <= 256)."""
    node_bits, idf = device_tree(voc, desc_bits.device)
    k, levels = voc.k, voc.levels
    dev = desc_bits.device
    db = desc_bits.to(torch.float32)
    N = db.shape[0]
    wa = db.sum(dim=1)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    ar = torch.arange(k, device=dev)
    level_offset = 1
    for lvl in range(levels):
        child_bits = node_bits[(level_offset + node * k)[:, None] + ar]
        d = torch.einsum("nb,nkb->nk", db, child_bits)
        ham = wa[:, None] + child_bits.sum(dim=2) - 2.0 * d
        node = node * k + torch.argmin(ham, dim=1)
        level_offset += k ** (lvl + 1)
    n_words = k ** levels
    # term frequencies: a sum of ones, exact in any order
    tf = torch.zeros(n_words + 1, dtype=torch.float32, device=dev)
    tf.index_add_(0, torch.where(valid, node, n_words),
                  torch.ones(N, dtype=torch.float32, device=dev))
    v = tf[:n_words] * idf
    v = v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)
    return node.to(torch.int32), v


def transform_np(voc: Vocabulary, desc_bits: np.ndarray,
                 valid: np.ndarray | None = None):
    """Host-side descent on (N, 256) {0,1} descriptors (same tree walk as
    ``transform``; float64 vector)."""
    k, levels = voc.k, voc.levels
    node_bits = voc.node_bits
    db = np.asarray(desc_bits, dtype=np.float32)
    N = db.shape[0]
    wa = db.sum(axis=1)
    node = np.zeros(N, dtype=np.int64)
    level_offset = 1
    for lvl in range(levels):
        child_idx = (level_offset + node * k)[:, None] + np.arange(k)[None]
        child_bits = node_bits[child_idx].astype(np.float32)  # (N, k, 256)
        d = np.einsum("nb,nkb->nk", db, child_bits)
        ham = wa[:, None] + child_bits.sum(axis=2) - 2.0 * d
        node = node * k + ham.argmin(axis=1)
        level_offset += k ** (lvl + 1)
    return _histogram(voc, node.astype(np.int32), valid)


def transform_packed_np(voc: Vocabulary, desc_packed: np.ndarray,
                        valid: np.ndarray | None = None):
    """Host-side descent on packed (N, 32) uint8 descriptors: XOR and
    popcount (``np.bitwise_count``) over uint64 lanes.  Same tree walk and
    result as ``transform_np``."""
    node_packed = _packed_tree(voc)
    k, levels = voc.k, voc.levels
    db = np.ascontiguousarray(desc_packed, dtype=np.uint8).view(np.uint64)
    node = np.zeros(db.shape[0], dtype=np.int64)           # db: (N, 4)
    level_offset = 1
    for lvl in range(levels):
        child_idx = (level_offset + node * k)[:, None] + np.arange(k)[None]
        child = node_packed[child_idx]                       # (N, k, 4)
        ham = np.bitwise_count(np.bitwise_xor(child, db[:, None, :])).sum(
            axis=-1, dtype=np.int32)
        node = node * k + ham.argmin(axis=1)
        level_offset += k ** (lvl + 1)
    return _histogram(voc, node.astype(np.int32), valid)


def _histogram(voc: Vocabulary, words: np.ndarray, valid):
    """(words, L1-normalized tf-idf vector) of one descriptor set."""
    if valid is None:
        valid = np.ones(len(words), dtype=bool)
    tf = np.bincount(words[valid], minlength=voc.n_words).astype(np.float64)
    v = tf * voc.idf
    return words, v / max(np.abs(v).sum(), 1e-9)


def score_l1(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity: 1 - 0.5 * |v1 - v2|_1 (vectors L1-normalized).
    v2 may be (K, W) -> (K,)."""
    diff = torch.sum(torch.abs(v1[None] - v2) if v2.ndim == 2
                     else torch.abs(v1 - v2), dim=-1)
    return 1.0 - 0.5 * diff
