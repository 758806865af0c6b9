"""Port parity: ops/orb.py and ops/orb_kernels.py against the JAX package.

The same float32 images, made with numpy from a seed, go through the JAX
functions (the Pallas kernels in interpret mode, as tests/test_orb.py runs
them) and their counterparts in the port, on the CPU.

Tolerances:
  * constants (FAST ring, disc, BRIEF pattern and offsets, interpolation
    matrices): exact — they are what the two packages carry across;
  * FAST: corners exact; scores exact on integer images (sums of integers)
    and within rtol 1e-6 on resized images against ``fast_score`` (XLA sums
    the 16 ring terms in another order), exact against the Pallas kernel
    (the same ring order);
  * patch gather, ``nms3``, ``select_keypoints`` (ties included): exact;
  * ``_resize_bilinear``: atol 2e-4 (f32 products rounded differently);
  * ``orient_and_brief``: angles within 1e-3 deg, >= 99.5% of descriptors
    bit-equal (a keypoint on a 12-deg bin edge may flip bins);
  * ``extract_orb_batch``: level-0 keypoints, octaves and responses
    identical, angles within 1e-3 deg; >= 99% of all valid features equal,
    where equal is the same octave and uv and a descriptor within 4 bits of
    JAX's.  Bit-identical descriptors are not reachable against the jitted
    JAX function: inside ``jit`` XLA rounds the 7x7 blur through fused
    multiply-adds (jitted and eager ``_box_blur_patches`` disagree on ~28% of
    blurred values on these inputs; eager JAX and the port agree bit for
    bit), so a BRIEF test between two nearly equal samples can flip.  On
    these integer images >= 85% of level-0 descriptors are bit-identical
    (measured 90-95%, at most 2 bits apart).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.ops import orb as JORB
from snakeslam_tpu.ops.orb_pallas import (fast_score_pallas_batch,
                                          patch_gather_pallas)
from snakeslam_tpu_torch.ops import orb as TORB
from snakeslam_tpu_torch.ops import orb_kernels as OK

DESC_BITS_TOL = 4


def render_scene(rng, H=240, W=320, n_rects=40):
    """Gray background + random bright/dark rectangles (corner-rich), as
    tests/test_orb.py renders them."""
    img = np.full((H, W), 128.0, dtype=np.float32)
    for _ in range(n_rects):
        h = rng.integers(8, 40)
        w = rng.integers(8, 40)
        y = rng.integers(0, H - h)
        x = rng.integers(0, W - w)
        img[y:y + h, x:x + w] = rng.choice([40.0, 90.0, 170.0, 220.0])
    return img


def _textured(seed, B, H, W):
    """Integer-valued images: rectangles plus uint8 noise (many ties)."""
    rng = np.random.default_rng(seed)
    imgs = np.stack([render_scene(rng, H, W, n_rects=30) for _ in range(B)])
    imgs += rng.integers(-12, 13, size=imgs.shape)
    return np.clip(imgs, 0, 255).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constants_carried_across():
    assert np.array_equal(TORB.FAST_RING, JORB.FAST_RING)
    assert np.array_equal(TORB._DISC_MASK, JORB._DISC_MASK)
    assert np.array_equal(TORB.BRIEF_PATTERN, JORB.BRIEF_PATTERN)
    assert np.array_equal(TORB._BRIEF_OFFSETS, JORB._BRIEF_OFFSETS)
    for n_out, n_in in ((200, 240), (267, 320), (400, 480), (627, 752)):
        assert np.array_equal(TORB._interp_matrix(n_out, n_in),
                              JORB._interp_matrix(n_out, n_in))


@pytest.fixture(scope="module")
def fast_inputs():
    """B = 3 integer images at a shape that is no multiple of 64 or 128,
    and the same images downscaled by the JAX package's resize."""
    ints = _textured(1, 3, 101, 157)
    resized = np.asarray(JORB._resize_matmul(jnp.asarray(ints), 84, 131))
    return {"integer": ints, "resized": resized.astype(np.float32)}


@pytest.mark.parametrize("kind", ["integer", "resized"])
def test_fast_reference_matches_jax(fast_inputs, kind):
    imgs = fast_inputs[kind]
    s_t, c_t = OK.fast_score_batch_reference(_t(imgs), 20.0)
    s_t, c_t = s_t.numpy(), c_t.numpy()
    s_p, c_p = (np.asarray(a) for a in
                fast_score_pallas_batch(jnp.asarray(imgs), 20.0,
                                        interpret=True))
    assert np.array_equal(c_t, c_p)
    assert np.array_equal(s_t, s_p)
    for b in range(imgs.shape[0]):
        s_j, c_j = (np.asarray(a) for a in
                    JORB.fast_score(jnp.asarray(imgs[b]), 20.0))
        assert np.array_equal(c_t[b], c_j)
        if kind == "integer":
            assert np.array_equal(s_t[b], s_j)
        else:
            np.testing.assert_allclose(s_t[b], s_j, rtol=1e-6, atol=0)
    assert c_t.sum() > 100
    # the CPU wrapper takes the plain version and counts no launch
    launches = OK.FAST_LAUNCHES
    s_w, c_w = OK.fast_score_batch(_t(imgs), 20.0)
    assert torch.equal(c_w, torch.from_numpy(c_t))
    assert OK.FAST_LAUNCHES == launches
    s_1, c_1 = TORB.fast_score(_t(imgs[1]), 20.0)
    assert np.array_equal(s_1.numpy(), s_t[1])


def test_fast_compass_reject_is_exact():
    """The CUDA kernel skips the full ring for a pixel whose compass pixels
    (ring positions 0, 4, 8, 12) rule out a 9-arc.  Over all 65536 ring
    masks, every mask that the port's arc test takes as a corner has at
    least 2 compass bits, and two of them adjacent on the ring: (0 or 8)
    and (4 or 12), the test the kernel makes."""
    masks = torch.arange(1 << 16, dtype=torch.int32)
    arc = OK._arc9(masks)
    bit = {k: (masks >> k) & 1 for k in (0, 4, 8, 12)}
    n_compass = bit[0] + bit[4] + bit[8] + bit[12]
    adjacent = ((bit[0] | bit[8]) & (bit[4] | bit[12])) == 1
    assert int(arc.sum()) > 0
    assert bool((n_compass[arc] >= 2).all())
    assert bool(adjacent[arc].all())
    # both are tight: a 9-arc can hold exactly 2 compass bits, and the
    # adjacent test rejects masks the count test lets through (N and S)
    assert int(n_compass[arc].min()) == 2
    assert bool(((n_compass >= 2) & ~adjacent).any())


def test_patch_gather_reference_matches_pallas():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 104, 384)).astype(np.float32)
    yt = rng.integers(0, (104 - 48) // 8, (2, 13)).astype(np.int32)
    xt = rng.integers(0, (384 - 128) // 128 + 1, (2, 13)).astype(np.int32)
    want = np.asarray(patch_gather_pallas(
        jnp.asarray(img), jnp.asarray(yt), jnp.asarray(xt), 48, 128))
    got = OK.patch_gather(_t(img), _t(yt), _t(xt), 48, 128)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        OK.patch_gather_reference(_t(img), _t(yt), _t(xt), 48, 128).numpy(),
        want)


@pytest.mark.parametrize("bad", ["y", "x", "negative"])
def test_patch_gather_rejects_blocks_outside_the_image(bad):
    img = torch.zeros((1, 104, 384))
    yt = torch.zeros((1, 2), dtype=torch.int32)
    xt = torch.zeros((1, 2), dtype=torch.int32)
    if bad == "y":
        yt[0, 1] = (104 - 48) // 8 + 1
    elif bad == "x":
        xt[0, 1] = 3
    else:
        yt[0, 0] = -1
    with pytest.raises(ValueError, match="leaves"):
        OK.patch_gather(img, yt, xt, 48, 128)
    with pytest.raises(ValueError, match="multiples"):
        OK.patch_gather(img, yt * 0, xt * 0, 44, 128)


def _score_maps(seed):
    """NMS inputs: FAST scores of integer images, and a tie-heavy map of
    small integers (equal values in every cell)."""
    imgs = _textured(seed, 2, 90, 150)
    fast = OK.fast_score_batch_reference(_t(imgs), 20.0)[0].numpy()
    rng = np.random.default_rng(seed)
    ties = rng.integers(0, 4, size=(2, 90, 150)).astype(np.float32)
    return {"fast": fast, "ties": ties}


@pytest.mark.parametrize("kind", ["fast", "ties"])
def test_nms_and_selection_exact(kind):
    score = _score_maps(3)[kind]
    for b in range(score.shape[0]):
        n_j = np.asarray(JORB.nms3(jnp.asarray(score[b])))
        n_t = TORB.nms3(_t(score[b])).numpy()
        assert np.array_equal(n_t, n_j)
    sel_in = score if kind == "ties" else np.stack(
        [np.asarray(JORB.nms3(jnp.asarray(s))) for s in score])
    for n in (50, 200, 2000):     # 2000 > candidates: the padded branch
        got = TORB.select_keypoints(_t(sel_in), n)
        for b in range(sel_in.shape[0]):
            want = JORB.select_keypoints(jnp.asarray(sel_in[b]), n)
            for g, w in zip(got, want):
                assert np.array_equal(g[b].numpy(), np.asarray(w))


def test_resize_matmul():
    imgs = _textured(4, 2, 240, 320)
    for h, w in ((200, 267), (167, 222)):
        want = np.asarray(JORB._resize_matmul(jnp.asarray(imgs), h, w))
        got = TORB._resize_bilinear(_t(imgs), h, w).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_resize_and_angles_round_as_numpy():
    """The pyramid's resize is, per output, two products and a sum, each
    rounded on its own, and the orientation's moments are float64 sums
    that no summation order changes: numpy's elementwise arithmetic, in
    another order, gives the same bits, as a CUDA device does (no library
    reduction or fused multiply-add decides them)."""
    imgs = _textured(8, 2, 240, 320)
    for h, w in ((200, 267), (167, 222)):
        x = imgs
        for dim, n in ((1, h), (2, w)):
            c0, c1, w0, w1 = TORB._interp_taps(n, x.shape[dim])
            m = TORB._interp_matrix(n, x.shape[dim])
            rows = np.arange(n)
            assert np.array_equal(m[rows, c0], w0)
            assert np.array_equal(np.where(c1 != c0, m[rows, c1], 0), w1)
            assert ((m != 0).sum(axis=1) == 1 + (c1 != c0)).all()
            shape = [1, 1, 1]
            shape[dim] = n
            x = (np.take(x, c0, axis=dim) * w0.reshape(shape)
                 + np.take(x, c1, axis=dim) * w1.reshape(shape))
        level = TORB._resize_bilinear(_t(imgs), h, w)
        np.testing.assert_array_equal(level.numpy(), x)
        score = TORB.nms3(OK.fast_score_batch_reference(level, 20.0)[0])
        uv, _, valid = TORB.select_keypoints(score, 200)
        ang, _ = TORB.orient_and_brief(level, uv)
        src = TORB._extract_patches(level, uv, TORB._BRIEF_SRC).numpy()
        o, n = TORB._CENTER_OFF, TORB._PATCH
        c = src[..., o:o + n, o:o + n].astype(np.float64)[..., ::-1, ::-1]
        wx = (TORB._disc_x * TORB._DISC_MASK)[::-1, ::-1]
        wy = (TORB._disc_y * TORB._DISC_MASK)[::-1, ::-1]
        want = np.degrees(np.arctan2((c * wy).sum(axis=(-2, -1)),
                                     (c * wx).sum(axis=(-2, -1))))
        want = want.astype(np.float32)
        want = np.where(want < 0, want + np.float32(360.0), want)
        assert int(valid.sum()) > 100
        np.testing.assert_array_equal(ang.numpy()[valid.numpy()],
                                      want[valid.numpy()])


def test_box_blurs():
    imgs = _textured(5, 2, 60, 70)
    np.testing.assert_array_equal(
        TORB.box_blur_batch(_t(imgs)).numpy(),
        np.asarray(JORB.box_blur_batch(jnp.asarray(imgs))))
    p = imgs[:, :46, :46]
    np.testing.assert_array_equal(
        TORB._box_blur_patches(_t(p)).numpy(),
        np.asarray(JORB._box_blur_patches(jnp.asarray(p))))


def test_orient_and_brief():
    imgs = _textured(6, 2, 240, 320)
    score = TORB.nms3(OK.fast_score_batch_reference(_t(imgs), 20.0)[0])
    uv, _, _ = TORB.select_keypoints(score, 300)
    ang_t, bits_t = TORB.orient_and_brief(_t(imgs), uv)
    for b in range(2):
        ang_j, bits_j = JORB.orient_and_brief(jnp.asarray(imgs[b]),
                                              jnp.asarray(uv[b].numpy()))
        d = np.abs(ang_t[b].numpy() - np.asarray(ang_j))
        d = np.minimum(d, 360.0 - d)
        assert d.max() < 1e-3, d.max()
        same = (bits_t[b].numpy() == np.asarray(bits_j)).all(axis=1)
        assert same.mean() >= 0.995, same.mean()


def _feature_table(f, b):
    """{(octave, u, v): (response, angle, descriptor bytes)} of the valid
    features of frame b."""
    valid = np.asarray(f.valid[b], dtype=bool)
    uv = np.asarray(f.uv[b], dtype=np.float32)[valid]
    octv = np.asarray(f.octave[b])[valid]
    resp = np.asarray(f.response[b], dtype=np.float32)[valid]
    ang = np.asarray(f.angle[b], dtype=np.float64)[valid]
    bits = np.asarray(f.desc_bits[b], dtype=np.int8)[valid]
    return {(int(o), float(u), float(v)): (r, a, d.tobytes())
            for o, (u, v), r, a, d in zip(octv, uv, resp, ang, bits)}


def _hamming(a: bytes, b: bytes) -> int:
    return int((np.frombuffer(a, np.int8) != np.frombuffer(b, np.int8)).sum())


def test_extract_orb_batch():
    imgs = _textured(7, 2, 240, 320)
    ft = TORB.extract_orb_batch(_t(imgs), n_features=600, levels=4)
    fj = JORB.extract_orb_batch(jnp.asarray(imgs), n_features=600, levels=4)
    assert ft.uv.shape == (2, 600, 2) and ft.desc_bits.dtype == torch.int8
    for b in range(2):
        tt, tj = _feature_table(ft, b), _feature_table(fj, b)
        l0t = {k: v for k, v in tt.items() if k[0] == 0}
        l0j = {k: v for k, v in tj.items() if k[0] == 0}
        assert l0t.keys() == l0j.keys() and len(l0t) > 100
        exact = 0
        for k in l0t:
            assert l0t[k][0] == l0j[k][0]
            assert abs(l0t[k][1] - l0j[k][1]) < 1e-3
            assert _hamming(l0t[k][2], l0j[k][2]) <= DESC_BITS_TOL
            exact += l0t[k][2] == l0j[k][2]
        assert exact >= 0.85 * len(l0t), (exact, len(l0t))
        same = sum(1 for k in tt if k in tj
                   and _hamming(tt[k][2], tj[k][2]) <= DESC_BITS_TOL)
        assert same >= 0.99 * max(len(tt), len(tj)), (same, len(tt), len(tj))
        assert {k[0] for k in tt} == {0, 1, 2, 3}
    # the single-image entry point is the batch of one
    f1 = TORB.extract_orb(_t(imgs[1]), n_features=600, levels=4)
    assert torch.equal(f1.desc_bits, ft.desc_bits[1])
    assert torch.equal(f1.uv, ft.uv[1])
