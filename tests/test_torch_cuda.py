"""The CUDA pose kernel on the card, against its plain PyTorch version.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when no NVIDIA GPU is present (a CUDA kernel has no CPU mode).  On a card:
``python -m pytest tests/test_torch_cuda.py -q``.  This file imports no JAX.

Tolerances are those of tests/test_pose_pallas.py: pose atol 2e-4, inlier
agreement > 0.99, inlier counts within max(3, 1%) — the kernel's
fixed-order block reduction sums in another f32 order than torch.
"""

import numpy as np
import pytest
import torch

from snakeslam_tpu_torch.ops import pose_fused as PF
from snakeslam_tpu_torch.utils.pose_problems import pose_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(args):
    *tensors, cam, bf = args
    return [t[None] for t in tensors] + [cam, bf]


@pytest.mark.parametrize("N", [512, 1024])
@pytest.mark.parametrize("stereo", [True, False])
def test_kernel_matches_plain_version(cuda_device, N, stereo):
    args, T_gt = pose_problem(3 + N, N, stereo, cuda_device)
    launches = PF.LAUNCHES
    T, inl, n = PF.pose_refine_fused(*args, outer_iters=2, inner_iters=2)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == launches + 1
    Tr, ir, nr = PF.pose_refine_fused_reference(*_batch(args))
    np.testing.assert_allclose(T.cpu().numpy(), Tr[0].cpu().numpy(),
                               atol=2e-4)
    assert (inl == ir[0]).float().mean().item() > 0.99
    n, nr = int(n), int(nr[0])
    assert abs(n - nr) <= max(3, nr // 100), (n, nr)
    assert n == int(inl.sum())
    assert np.linalg.norm(T.cpu().numpy()[:3, 3] - T_gt[:3, 3]) < 2e-3


def test_kernel_is_deterministic_and_batched(cuda_device):
    probs = [pose_problem(50 + k, 1024, k % 2 == 0, cuda_device)[0]
             for k in range(3)]
    stack = [torch.stack([p[i] for p in probs]) for i in range(6)]
    cam, bf = probs[0][6], probs[0][7]
    a = PF.pose_refine_fused(*stack, cam, bf, outer_iters=1, inner_iters=3)
    b = PF.pose_refine_fused(*stack, cam, bf, outer_iters=1, inner_iters=3)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y), "reruns must be bit-identical"
    for k, p in enumerate(probs):
        T1, i1, n1 = PF.pose_refine_fused(*p, outer_iters=1, inner_iters=3)
        assert torch.equal(a[0][k], T1) and torch.equal(a[1][k], i1)
        assert int(a[2][k]) == int(n1)


def test_kernel_rejects_bad_inputs(cuda_device):
    args, _ = pose_problem(7, 512, True, cuda_device)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError, match="float32"):
        PF.pose_refine_fused(*bad)
    bad = list(args)
    bad[2] = bad[2][:100]
    with pytest.raises(ValueError, match="shape"):
        PF.pose_refine_fused(*bad)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError, match="mixed devices"):
        PF.pose_refine_fused(*bad)


def test_windowed_slice_goes_through_the_kernel(cuda_device):
    """A short dense-keyframe slice on the card: every window launches the
    kernel twice per frame slot, and the GPU run tracks like the CPU run."""
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    def run(device):
        world = SyntheticWorld(n_points=1500, seed=7)
        s = Settings()
        s.input_type = InputType.Stereo
        s.enable_imu = False
        s.feature_slots = 512
        s.th_depth = 25.0
        apply_world_to_settings(world, s)
        system = SlamSystem(s, device)
        frames = list(synthetic_frames(
            world, orbit_trajectory(48, radius=7.0, arc=0.144, fps=200.0), s))
        for f in frames:
            f.timestamp = f.frame_id / 10.0
        runner = WindowedRunner(system, window=8)
        launches = PF.LAUNCHES
        runner.run(frames)
        return system, runner, PF.LAUNCHES - launches

    gpu, runner, launches = run(cuda_device)
    torch.cuda.synchronize()
    assert launches == 2 * runner.window * runner.n_device_calls > 0
    cpu, _, cpu_launches = run("cpu")
    assert cpu_launches == 0
    assert len(gpu.tracker.trajectory) == len(cpu.tracker.trajectory) == 48
    assert gpu.map.n_keyframes == cpu.map.n_keyframes
    ate_g = gpu.ate_against_gt(with_scale=False)[0]
    ate_c = cpu.ate_against_gt(with_scale=False)[0]
    assert abs(ate_g - ate_c) <= 0.1 * ate_c, (ate_g, ate_c)
