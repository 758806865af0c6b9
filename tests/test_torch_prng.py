"""The port's threefry keys and draws against ``jax.random``, bit for bit.

Exact throughout: ``PRNGKey`` for seeds below and above 2**32 and a
negative one; ``split`` into 2 and 3; ``random_bits`` at 32 and 64 bits;
``uniform`` in float32 and float64 at the lanes' shapes with ``minval``
1e-9 (the RANSACs' draw) and at another range, compared as bit patterns;
the default dtype following ``prng.x64`` as JAX's follows
``jax_enable_x64``; ``sample_without_replacement`` against
``jax.lax.top_k`` of the JAX package's Gumbel draw, in order, over drawn
seeds, mask sizes and sample sizes.  The words (int64 tensors masked to 32
bits) equal JAX's threefry at counts whose high word is not 0, and the
emulated fused multiply-add rounds as one exact rounding does.  The tests'
configuration turns
``jax_enable_x64`` on, so every JAX call here may ask for either dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from snakeslam_tpu_torch.core import prng


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.itemsize == 4 else np.uint64)


@pytest.mark.parametrize("seed", [0, 7, 29, 123456789, 2**33 + 5, -3])
def test_prng_key(seed):
    with prng.x64(True):
        np.testing.assert_array_equal(prng.PRNGKey(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    assert prng.PRNGKey(seed).dtype == np.uint32
    # without x64 a seed keeps its low 32 bits, as JAX's does
    with prng.x64(False):
        np.testing.assert_array_equal(
            prng.PRNGKey(seed), [0, seed & 0xFFFFFFFF])


@pytest.mark.parametrize("num", [2, 3])
@pytest.mark.parametrize("seed", [0, 7, 2**40 + 1])
def test_split(seed, num):
    with prng.x64(True):
        key = prng.PRNGKey(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(key, num),
                                  np.asarray(jax.random.split(jkey, num)))
    # a split of a split, as the lanes chain them
    np.testing.assert_array_equal(
        prng.split(prng.split(key, num)[-1]),
        np.asarray(jax.random.split(jax.random.split(jkey, num)[-1])))


@pytest.mark.parametrize("width", [32, 64])
def test_random_bits(width):
    jkey = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bits(jkey, (37, 129),
                                      dtype=getattr(jnp, f"uint{width}")))
    got = prng.random_bits(np.asarray(jkey), (37, 129), width).numpy()
    if width == 32:
        assert got.min() >= 0 and got.max() < 2**32
        got = got.astype(np.uint32)
    np.testing.assert_array_equal(got.view(want.dtype), want)


@pytest.mark.parametrize("shape", [(256, 1024), (128, 64), (512, 300)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform(dtype, shape):
    jkey = jax.random.PRNGKey(5)
    want = jax.random.uniform(jkey, shape, dtype=getattr(jnp, dtype),
                              minval=1e-9, maxval=1.0)
    got = prng.uniform(np.asarray(jkey), shape, getattr(torch, dtype),
                       1e-9, 1.0)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # another range: XLA scales by a fused multiply-add, matched too
    want = jax.random.uniform(jkey, (64, 100), dtype=getattr(jnp, dtype),
                              minval=-3.7, maxval=11.2)
    got = prng.uniform(np.asarray(jkey), (64, 100), getattr(torch, dtype),
                       -3.7, 11.2)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_default_dtype_follows_x64():
    jkey = jax.random.PRNGKey(3)
    want = jax.random.uniform(jkey, (16, 33), minval=1e-9, maxval=1.0)
    assert want.dtype == jnp.float64          # the tests run with x64 on
    with prng.x64(True):
        got = prng.uniform(np.asarray(jkey), (16, 33), minval=1e-9)
    assert prng.draw_dtype() == torch.float32     # restored
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert prng.uniform(np.asarray(jkey), (4,)).dtype == torch.float32


def _jax_topk(jkey, mask, n_hypotheses, k, dtype):
    """The draw of the JAX package's RANSACs (ops/twoview.py:113-117)."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(
        jkey, (n_hypotheses, len(mask)), dtype=dtype, minval=1e-9,
        maxval=1.0)))
    return np.asarray(jax.lax.top_k(logits[None, :] + gumbel, k)[1])


@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), n_valid=st.integers(1, 600),
       k=st.sampled_from([3, 4, 6, 8]), x64=st.booleans(),
       scatter=st.booleans())
def test_sample_without_replacement_is_jax_gumbel_top_k(seed, n_valid, k,
                                                        x64, scatter):
    N = 256 * (-(-n_valid // 256))
    rng = np.random.default_rng(seed)
    mask = np.zeros(N, dtype=bool)
    if scatter:                 # valid entries anywhere, not a prefix
        mask[rng.choice(N, n_valid, replace=False)] = True
    else:
        mask[:n_valid] = True
    jkey = jax.random.PRNGKey(seed)
    want = _jax_topk(jkey, mask, 64, k, jnp.float64 if x64 else jnp.float32)
    with prng.x64(x64):
        got = prng.sample_without_replacement(
            np.asarray(jkey), torch.as_tensor(mask), 64, k)
    assert got.dtype == torch.int64 and got.shape == (64, k)
    np.testing.assert_array_equal(got.numpy(), want)
    valid = mask[got.numpy()]
    assert valid.all() if n_valid >= k else valid.sum(1).min() == n_valid


def test_sample_without_replacement_at_the_lanes_shapes():
    """The mono initializer's (256 x 2048, 8 of 1500) and (128 x 2048, 4),
    the loop closer's (128 x 512, 3 of 300), float32 and float64."""
    for x64, jdt in ((False, jnp.float32), (True, jnp.float64)):
        for (H, N, n, k, seed) in ((256, 2048, 1500, 8, 1),
                                   (128, 2048, 1500, 4, 2),
                                   (128, 512, 300, 3, 7)):
            mask = np.arange(N) < n
            jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
            with prng.x64(x64):
                got = prng.sample_without_replacement(
                    np.asarray(jkey), torch.as_tensor(mask), H, k)
            np.testing.assert_array_equal(
                got.numpy(), _jax_topk(jkey, mask, H, k, jdt))


@pytest.mark.parametrize("f32", [True, False])
def test_words_past_2_32_and_the_fused_multiply_add(f32):
    """Counts that straddle 2**32 (the high count word in use) give JAX's
    threefry words; ``_fma`` gives the correctly rounded a * b + c."""
    from fractions import Fraction
    from jax._src.prng import threefry2x32_p

    n = 3 * 4099
    counts = np.arange(2**32 - 5000, 2**32 - 5000 + n, dtype=np.uint64)
    hi, lo = (counts >> 32).astype(np.uint32), counts.astype(np.uint32)
    want = threefry2x32_p.bind(np.full(n, 0x9E3779B9, np.uint32),
                               np.full(n, 77, np.uint32), hi, lo)
    got = prng.threefry2x32(0x9E3779B9, 77,
                            torch.from_numpy(hi.astype(np.int64)),
                            torch.from_numpy(lo.astype(np.int64)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))
    u = prng._unit_floats(*got, f32)
    dt = np.float32 if f32 else np.float64
    assert u.min() >= 0 and u.max() < 1
    b, c = dt(11.2) - dt(-3.7), dt(-3.7)
    f = prng._fma(u, torch.full_like(u, float(b)),
                  torch.full_like(u, float(c))).numpy()
    for ui, fi in zip(u.numpy()[:1500], f[:1500]):
        exact = Fraction(float(ui)) * Fraction(float(b)) + Fraction(float(c))
        # fi is the nearest of the dtype: its neighbours are no nearer
        err = abs(Fraction(float(fi)) - exact)
        for nb in (np.nextafter(fi, dt(np.inf)),
                   np.nextafter(fi, dt(-np.inf))):
            e_nb = abs(Fraction(float(nb)) - exact)
            assert err < e_nb or (err == e_nb and
                                  int(fi.view(np.int32 if f32 else np.int64))
                                  % 2 == 0)
