"""Port parity: the fused pose refine's plain version against the Pallas
kernel, run as the JAX package's own tests run it on the CPU
(``interpret=True``), at the slot counts of the tracking window.

Tolerances: pose atol 1e-4, >= 99.5% identical inlier flags, inlier counts
within max(2, 0.5%) — the two sum the 27 normal-equation terms in another
f32 order.  Beside the window's slot counts: N = 128 (one CTA of the CUDA
kernel) and N = 2048 (its threads loop over features), and the edge cases
of ``utils/pose_problems.py`` (every feature masked; points behind the
camera).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.ops.pose_pallas import pose_refine_fused as jax_fused
from snakeslam_tpu_torch.ops import pose_fused as PF
from snakeslam_tpu_torch.utils.pose_problems import (BF, CAM, EDGE_CASES,
                                                     pose_problem)


def _run_both(seed, N, stereo, outer, inner, problem=pose_problem):
    args, T_gt = problem(seed, N, stereo, "cpu")
    jcam = JPinhole(*(jnp.float32(c) for c in CAM))
    Tj, ij, nj = jax_fused(
        *(jnp.asarray(a.numpy()) for a in args[:6]), jcam, jnp.float32(BF),
        outer_iters=outer, inner_iters=inner, interpret=True)
    Tt, it, nt = PF.pose_refine_fused(*args, outer_iters=outer,
                                      inner_iters=inner)
    return (np.asarray(Tj), np.asarray(ij), int(nj)), \
        (Tt.numpy(), it.numpy(), int(nt)), T_gt


@pytest.mark.parametrize("N", [512, 1024])
@pytest.mark.parametrize("stereo", [True, False])
@pytest.mark.parametrize("iters", [(2, 2), (1, 3)])
def test_plain_version_matches_pallas(N, stereo, iters):
    launches = PF.LAUNCHES
    (Tj, ij, nj), (Tt, it, nt), T_gt = _run_both(3 + N, N, stereo, *iters)
    assert PF.LAUNCHES == launches, "CPU tensors must not launch the kernel"
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert (it == ij).mean() >= 0.995
    assert abs(nt - nj) <= max(2, nj // 200), (nt, nj)
    assert nt == int(it.sum())
    # both land on the ground-truth pose
    assert np.linalg.norm(Tt[:3, 3] - T_gt[:3, 3]) < 2e-3
    np.testing.assert_allclose(Tt[:3, :3] @ Tt[:3, :3].T, np.eye(3),
                               atol=1e-5)


@pytest.mark.parametrize("N", [128, 2048])
def test_plain_version_matches_pallas_at_other_widths(N):
    (Tj, ij, nj), (Tt, it, nt), T_gt = _run_both(3 + N, N, True, 2, 2)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert (it == ij).mean() >= 0.995
    assert abs(nt - nj) <= max(2, nj // 200), (nt, nj)
    assert nt == int(it.sum()) > N // 4
    assert np.linalg.norm(Tt[:3, 3] - T_gt[:3, 3]) < 2e-3


@pytest.mark.parametrize("kind", sorted(EDGE_CASES))
def test_plain_version_matches_pallas_on_edge_cases(kind):
    problem = EDGE_CASES[kind]
    (Tj, ij, nj), (Tt, it, nt), T_gt = _run_both(11, 512, True, 2, 2,
                                                 problem)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert (it == ij).mean() >= 0.995
    assert abs(nt - nj) <= max(2, nj // 200), (nt, nj)
    args, _ = problem(11, 512, True, "cpu")
    if kind == "all_masked":
        # the damping alone: no step, T_init re-orthonormalized
        T0 = args[0][None]
        want = PF.lie.se3(PF._gram_schmidt(T0[:, :3, :3]), T0[:, :3, 3])[0]
        np.testing.assert_array_equal(Tt, want.numpy())
        assert nt == nj == 0 and not it.any()
    else:
        # the points behind the camera fail the depth gate
        pts, T0 = args[1].numpy(), args[0].numpy()
        z = pts @ T0[2, :3] + T0[2, 3]
        assert (z < 0).sum() >= 128
        assert not it[z < 0].any() and not ij[z < 0].any()
        assert np.linalg.norm(Tt[:3, 3] - T_gt[:3, 3]) < 2e-3


def test_batched_plain_version_equals_unbatched():
    probs = [pose_problem(40 + k, 512, k % 2 == 0, "cpu")[0]
             for k in range(3)]
    stack = [torch.stack([p[i] for p in probs]) for i in range(6)]
    Tb, ib, nb = PF.pose_refine_fused(*stack, *probs[0][6:])
    assert Tb.shape == (3, 4, 4) and ib.shape == (3, 512)
    assert nb.dtype == torch.int32
    for k, p in enumerate(probs):
        T1, i1, n1 = PF.pose_refine_fused(*p)
        np.testing.assert_allclose(Tb[k].numpy(), T1.numpy(), atol=1e-6)
        assert torch.equal(ib[k], i1) and int(nb[k]) == int(n1)


def test_wrapper_rejects_mixed_devices():
    args = list(pose_problem(5, 512, True, "cpu")[0])
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="mixed devices"):
        PF.pose_refine_fused(*args)
