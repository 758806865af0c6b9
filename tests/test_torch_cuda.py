"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when no NVIDIA GPU is present (a CUDA kernel has no CPU mode).  On a card:
``python -m pytest tests/test_torch_cuda.py -q``.  This file imports no JAX.

Pose kernel tolerances are those of tests/test_pose_pallas.py: pose atol
2e-4, inlier agreement > 0.99, inlier counts within max(3, 1%) — the
kernel's fixed-order cluster reduction sums in another f32 order than
torch.  It is held at N = 128 (one CTA), 512, 1000 (a ragged CTA), 1024 and
2048 (threads loop over features), B = 1 and 3, both iteration schedules,
stereo and mono, and on the edge cases of ``utils/pose_problems.py``;
reruns are bit-identical and a batched call equals its unbatched calls bit
for bit.  The FAST kernel sums in its plain version's order and the patch
gather only copies, so both are held bit-identical; FAST at W = 752 (the
float4 path), 627 and 157 (scalar), H = 7 (less than a tile) and 120, B = 1
and 64, a misaligned input and corners on tile and 4-pixel-run
boundaries, and the four pyramid levels of a rendered 640x480 TUM frame as
``FeatureDetector.detect`` hands them over (the dataset CLI's inputs);
the whole ORB front-end on the card gives the CPU's features bit for bit.

The keyframe back-end's ops (plain torch, no hand kernel) run on the card
without a host sync (``torch.cuda.set_sync_debug_mode("error")``): the
local BA's solve is bit-identical on a rerun and within 1e-4 of the CPU;
pair triangulation's integer outputs equal the CPU's.  So do the loop
closure's pose-graph solve (float64, within 1e-8 of the CPU, bit-identical
rerun) and Sim3 RANSAC, its threefry draw equal to the CPU's; the pose
kernel takes the realign's batch of 320 problems in one launch.  A card
system's monocular initializer initializes as the CPU's does (its
two-view geometry on the host).

The monocular visual-inertial path: the pose kernel on the mono problems a
small mono-VI run hands it (a window's coarse and fine problem after the
visual-inertial initialization; the same tolerances, reruns bit-identical);
``window_track`` with ``use_imu=True`` on the card against the CPU (poses
1e-4, decisions identical); ``solve_scale_gravity`` and ``solve_imu_chain``
in float64 on the card within 1e-9 of the CPU.

The dataset CLI's device paths: the RGB-D depth filter on the rendered TUM
lane's depth (with flying pixels and holes added) and TSDF integration of
its first frames, each on the card against the CPU (kept pixels and
weights identical, values within 1e-5); async mode on the card (producer
thread, async local BA) with exact FAST and pose launch counts.

The multi-device path: the sharded BA step (float64) on four shards of one
card without a host sync, bit-identical on a rerun, within 1e-9 of four
CPU shards, and the sharded matcher exact; one shard a card where the
machine has two or more (skipped below two).

The graph layer (``utils/graphs.py``): every compiled program (the
tracking window, the coarse and fine tracking steps, the local-BA solve;
ORB on one image and on a batch, the stereo front-end, the IMU chain
solve, the triangulation pool, the fusion searches (the pool program on
16 rows and on one), the three global-BA passes and PGO on the inputs of
``utils/graph_cases.py``) replays bit for bit what its eager run
computes, and a rerun replays the same bits; ``LAUNCHES`` counts a
replay's pose launches and ``FAST_LAUNCHES`` an ORB replay's FAST
launches; a program keeps its most recently used graphs; the graphs of a
cloning program share one pool and each call's outputs stay its own; a
worker thread captures while the main thread replays; a failed capture
raises and never reruns the eager version.
"""

import numpy as np
import pytest
import torch

from snakeslam_tpu_torch.ops import orb as ORB
from snakeslam_tpu_torch.ops import orb_kernels as OK
from snakeslam_tpu_torch.ops import pose_fused as PF
from snakeslam_tpu_torch.utils import graphs
from snakeslam_tpu_torch.utils.pose_problems import EDGE_CASES, pose_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(args):
    *tensors, cam, bf = args
    return [t[None] for t in tensors] + [cam, bf]


def _stack(probs):
    stack = [torch.stack([p[i] for p in probs]) for i in range(6)]
    return stack + [probs[0][6], probs[0][7]]


def _check_pose(T, inl, n, Tr, ir, nr):
    """The kernel's (T, inl, n) against the plain version's, batched."""
    np.testing.assert_allclose(T.cpu().numpy(), Tr.cpu().numpy(), atol=2e-4)
    assert (inl == ir).float().mean().item() > 0.99
    for c, cr, f in zip(n.reshape(-1).tolist(), nr.reshape(-1).tolist(),
                        inl.reshape(n.numel(), -1)):
        assert abs(c - cr) <= max(3, cr // 100), (c, cr)
        assert c == int(f.sum())


@pytest.mark.parametrize("N", [128, 512, 1000, 1024, 2048])
@pytest.mark.parametrize("stereo", [True, False])
def test_kernel_matches_plain_version(cuda_device, N, stereo):
    for B in (1, 3):
        probs = [pose_problem(3 + N + k, N, stereo, cuda_device)
                 for k in range(B)]
        args = _stack([p[0] for p in probs]) if B > 1 else probs[0][0]
        batched = args if B > 1 else _batch(args)
        for outer, inner in ((1, 3), (2, 2)):
            kw = dict(outer_iters=outer, inner_iters=inner)
            launches = PF.LAUNCHES
            T, inl, n = PF.pose_refine_fused(*args, **kw)
            T2, inl2, n2 = PF.pose_refine_fused(*args, **kw)
            torch.cuda.synchronize()
            assert PF.LAUNCHES == launches + 2
            assert torch.equal(T, T2) and torch.equal(inl, inl2) \
                and torch.equal(n, n2), "reruns must be bit-identical"
            Tr, ir, nr = PF.pose_refine_fused_reference(*batched, **kw)
            if B == 1:
                Tr, ir, nr = Tr[0], ir[0], nr[0]
            _check_pose(T, inl, n, Tr, ir, nr)
            # the ground truth after the full (2, 2) schedule, where 60
            # outliers and 40 masked slots leave enough features
            if N < 512 or outer == 1:
                continue
            T_gt = np.stack([p[1] for p in probs])
            err = np.linalg.norm(T.cpu().numpy().reshape(B, 4, 4)[:, :3, 3]
                                 - T_gt[:, :3, 3], axis=-1)
            assert err.max() < 2e-3, err


@pytest.mark.parametrize("kind", sorted(EDGE_CASES))
@pytest.mark.parametrize("stereo", [True, False])
def test_kernel_edge_cases(cuda_device, kind, stereo):
    args, T_gt = EDGE_CASES[kind](11, 1000, stereo, cuda_device)
    for outer, inner in ((1, 3), (2, 2)):
        kw = dict(outer_iters=outer, inner_iters=inner)
        T, inl, n = PF.pose_refine_fused(*args, **kw)
        Tr, ir, nr = PF.pose_refine_fused_reference(*_batch(args), **kw)
        torch.cuda.synchronize()
        _check_pose(T, inl, n, Tr[0], ir[0], nr[0])
        if kind == "all_masked":
            assert int(n) == 0 and not bool(inl.any())
            T0 = args[0][None]
            want = PF.lie.se3(PF._gram_schmidt(T0[:, :3, :3]), T0[:, :3, 3])
            np.testing.assert_allclose(T.cpu().numpy(), want[0].cpu().numpy(),
                                       atol=1e-6)
        else:
            T0 = args[0]
            z = args[1] @ T0[2, :3] + T0[2, 3]
            assert int((z < 0).sum()) >= 250
            assert not bool(inl[z < 0].any())
            assert np.linalg.norm(T.cpu().numpy()[:3, 3] - T_gt[:3, 3]) < 2e-3


@pytest.mark.parametrize("N", [128, 1000, 1024, 2048])
def test_kernel_is_deterministic_and_batched(cuda_device, N):
    probs = [pose_problem(50 + k, N, k % 2 == 0, cuda_device)[0]
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
    assert gpu.lba.n_runs == cpu.lba.n_runs > 0
    ate_g = gpu.ate_against_gt(with_scale=False)[0]
    ate_c = cpu.ate_against_gt(with_scale=False)[0]
    assert abs(ate_g - ate_c) <= 0.1 * ate_c, (ate_g, ate_c)


def _rendered_views(n_frames, seed=3):
    """Rendered 320x240 uint8 stereo pairs (the pixels slice's world)."""
    from snakeslam_tpu_torch.utils.render_world import render_sequence
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    world = SyntheticWorld(n_points=900, seed=seed, image_size=(320, 240),
                           fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                           baseline=0.12, extent=8.0)
    views = list(render_sequence(
        world, orbit_trajectory(n_frames, radius=6.5, arc=0.5, fps=20.0)))
    L = np.stack([v[2].astype(np.uint8) for v in views])
    R = np.stack([v[3].astype(np.uint8) for v in views])
    return L, R, [v[0] for v in views], [v[1] for v in views]


@pytest.mark.parametrize("kind", ["integer", "resized", "odd"])
def test_fast_kernel_bit_identical(cuda_device, kind):
    L, R, _, _ = _rendered_views(4)
    imgs = torch.from_numpy(np.concatenate([L, R])).to(cuda_device).float()
    if kind == "resized":
        imgs = ORB._resize_bilinear(imgs, 167, 222)
    elif kind == "odd":
        imgs = imgs[:3, :101, :157].contiguous()
    launches = OK.FAST_LAUNCHES
    s, c = OK.fast_score_batch(imgs, 20.0)
    s2, c2 = OK.fast_score_batch(imgs, 20.0)
    torch.cuda.synchronize()
    assert OK.FAST_LAUNCHES == launches + 2
    sr, cr = OK.fast_score_batch_reference(imgs, 20.0)
    assert torch.equal(c, cr) and torch.equal(s, sr)
    assert torch.equal(c, c2) and torch.equal(s, s2)
    assert int(c.sum()) > 100


def _boundary_images(B, H, W, seed=0):
    """Integer noise plus bright and dark squares whose corners sit on the
    FAST kernel's tile edges (x = 127 / 128, y = 15 / 16) and on the edges
    of its 4-pixel runs (x = 3, 4, 5 and the last columns)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(90, 111, size=(B, H, W)).astype(np.float32)
    xs = [3, 4, 5, 123, 124, 126, 127, 128, 129, 255, 256, W - 9, W - 8]
    ys = [3, 4, 14, 15, 16, 17, 31, 32, H - 8]
    for b in range(B):
        for k, (x, y) in enumerate((x, y) for x in xs for y in ys):
            if 0 <= x < W and 0 <= y < H:
                imgs[b, y:y + 6, x:x + 6] = 200.0 if (k + b) % 2 else 10.0
    return torch.from_numpy(imgs)


@pytest.mark.parametrize("W", [752, 627, 157])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("H", [7, 120])
def test_fast_kernel_shapes_bit_identical(cuda_device, W, B, H):
    """The float4 path (W = 752), the scalar path (627, 157), images less
    than a tile high, on noise with corners on tile and run boundaries."""
    imgs = _boundary_images(B, H, W).to(cuda_device)
    s, c = OK.fast_score_batch(imgs, 20.0)
    sr, cr = OK.fast_score_batch_reference(imgs, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(c, cr) and torch.equal(s, sr)
    if H > 7:
        assert int(c.sum()) > 50 * B
        # corners on both sides of the tile edge at x = 127 / 128
        assert bool(c[..., 120:136].any())


def test_fast_kernel_on_a_tum_frame_pyramid(cuda_device, tmp_path,
                                            monkeypatch):
    """The dataset CLI's FAST inputs: one rendered 640x480 frame of the TUM
    lane through ``FeatureDetector.detect`` on the card under
    ``configs/tum.ini`` (four levels, B = 1 each), each level against the
    plain version, exact."""
    from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
    from snakeslam_tpu_torch.system.settings import Settings
    from snakeslam_tpu_torch.utils import tum_fixture as TF
    from snakeslam_tpu_torch.utils.render_world import render_frame

    s = Settings.from_ini(TF.copy_config(tmp_path / "tum.ini"))
    _, T = TF.lane_trajectory()[TF.LANE_FRAMES // 2]
    gray, _ = render_frame(TF.lane_world(), T, with_depth=True)
    seen = []
    inner = OK.fast_score_batch

    def record(imgs, threshold):
        seen.append((imgs.clone(), threshold))
        return inner(imgs, threshold)

    monkeypatch.setattr(OK, "fast_score_batch", record)
    # eagerly: inside ORB's compiled program the wrapper runs in the
    # warm-up and again in the capture, and a replay runs no Python
    with graphs.disabled():
        FeatureDetector(s, device=cuda_device).detect(
            np.clip(gray, 0, 255).astype(np.uint8), 0, 0.0)
    monkeypatch.undo()
    assert len(seen) == s.fd_levels == 4
    assert tuple(seen[0][0].shape) == (1, 480, 640)
    for imgs, th in seen:
        sc, co = OK.fast_score_batch(imgs, th)
        sr, cr = OK.fast_score_batch_reference(imgs, th)
        torch.cuda.synchronize()
        assert torch.equal(co, cr) and torch.equal(sc, sr)
        assert int(co.sum()) > 50


def test_orb_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """``FeatureDetector`` on the card gives the CPU's features bit for
    bit on rendered 640x480 TUM frames under ``configs/tum.ini``:
    keypoints, octaves, angles and descriptors (the pyramid's resize and
    the orientation moments round alike on both devices)."""
    from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
    from snakeslam_tpu_torch.system.settings import Settings
    from snakeslam_tpu_torch.utils import tum_fixture as TF
    from snakeslam_tpu_torch.utils.render_world import render_frame

    s = Settings.from_ini(TF.copy_config(tmp_path / "tum.ini"))
    world, traj = TF.lane_world(), TF.lane_trajectory()
    det = {d: FeatureDetector(s, device=d) for d in ("cpu", cuda_device)}
    for i in (0, TF.LANE_FRAMES - 1):
        gray, _ = render_frame(world, traj[i][1], with_depth=True)
        gray = np.clip(gray, 0, 255).astype(np.uint8)
        fc, fg = (det[d].detect(gray, i, 0.0) for d in ("cpu", cuda_device))
        assert fc.n > 900
        for name in ("uv", "octave", "angle", "descriptors"):
            assert np.array_equal(getattr(fc, name), getattr(fg, name)), name


def test_fast_kernel_misaligned_input(cuda_device):
    """A contiguous input whose data is not 16-byte aligned takes the
    scalar path, W % 4 == 0 notwithstanding."""
    imgs = _boundary_images(2, 40, 752)
    buf = torch.zeros(imgs.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(imgs.shape)
    shifted.copy_(imgs.to(cuda_device))
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    s, c = OK.fast_score_batch(shifted, 20.0)
    sr, cr = OK.fast_score_batch_reference(shifted, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(c, cr) and torch.equal(s, sr)
    assert int(c.sum()) > 50


@pytest.mark.parametrize("W", [384, 390])
def test_patch_gather_kernel_exact(cuda_device, W):
    """W = 384 takes the float4 path, W = 390 the scalar one."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 104, W)).astype(
        np.float32)).to(cuda_device)
    yt = torch.from_numpy(rng.integers(0, (104 - 48) // 8, (2, 13)).astype(
        np.int32)).to(cuda_device)
    xt = torch.from_numpy(rng.integers(0, (W - 128) // 128 + 1, (2, 13))
                          .astype(np.int32)).to(cuda_device)
    launches = OK.PATCH_LAUNCHES
    out = OK.patch_gather(img, yt, xt, 48, 128)
    torch.cuda.synchronize()
    assert OK.PATCH_LAUNCHES == launches + 1
    assert torch.equal(out, OK.patch_gather_reference(img, yt, xt, 48, 128))


def test_patch_gather_raises_not_falls_back(cuda_device):
    img = torch.zeros((1, 104, 384), device=cuda_device)
    yt = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    xt = torch.tensor([[0, 3]], dtype=torch.int32, device=cuda_device)
    launches = OK.PATCH_LAUNCHES
    with pytest.raises(ValueError, match="leaves"):
        OK.patch_gather(img, yt, xt, 48, 128)
    with pytest.raises(ValueError, match="mixed devices"):
        OK.patch_gather(img, yt.cpu(), xt, 48, 128)
    assert OK.PATCH_LAUNCHES == launches


def test_pixels_run_goes_through_the_fast_kernel(cuda_device):
    """48 rendered frames, chunk 16, window 16 on the card: one FAST launch
    per pyramid level per chunk, and the run tracks like the CPU run."""
    from snakeslam_tpu_torch.frontend.pixels import PixelFrameSequence
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner

    L, R, ts, gt = _rendered_views(48)

    def run(device):
        s = Settings()
        s.input_type = InputType.Stereo
        s.enable_imu = False
        s.width, s.height = 320, 240
        s.fx, s.fy, s.cx, s.cy = 260.0, 260.0, 160.0, 120.0
        s.bf = 260.0 * 0.12
        s.fd_features = 600
        s.fd_levels = 4
        s.feature_slots = 1024
        s.local_map_slots = 2048
        s.th_depth = 20.0
        system = SlamSystem(s, device)
        # the pixels lane keeps its reduced back-end (chip_smoke.py)
        lm = system.local_mapper
        lm.lba = None
        lm.map_searcher = None
        lm.backends = []
        lm._tri_dispatch = lambda *a, **k: None
        seq = PixelFrameSequence(s, L, R, ts, gt, chunk=16, device=device)
        fast = OK.FAST_LAUNCHES
        WindowedRunner(system, window=16).run(seq)
        return system, OK.FAST_LAUNCHES - fast

    gpu, launches = run(cuda_device)
    torch.cuda.synchronize()
    assert launches == 4 * 3
    cpu, cpu_launches = run("cpu")
    assert cpu_launches == 0
    assert len(gpu.tracker.trajectory) == len(cpu.tracker.trajectory) >= 43
    assert abs(gpu.map.n_keyframes - cpu.map.n_keyframes) <= 1
    ate_g = gpu.ate_against_gt(with_scale=False)[0]
    ate_c = cpu.ate_against_gt(with_scale=False)[0]
    assert abs(ate_g - ate_c) <= 0.2 * ate_c, (ate_g, ate_c)


def test_solve_ba_on_the_card(cuda_device):
    """An LBA-shaped problem (C = 32, P = 2048, M = 8): no host sync inside
    the solve, a bit-identical rerun, poses and points within 1e-4 of the
    CPU solve."""
    from snakeslam_tpu_torch.ops import ba as BA
    from snakeslam_tpu_torch.utils.backend_problems import ba_problem

    prob, cam, bf = ba_problem(32, 2048, 8, 0, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = BA.solve_ba(prob, cam, bf, iterations=3)
        out_mask = BA.classify_outliers(prob, cam, bf, out[0], out[1])
        again = BA.solve_ba(prob, cam, bf, iterations=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(out, again):
        assert torch.equal(a, b), "rerun not bit-identical"
    cprob, ccam, cbf = ba_problem(32, 2048, 8, 0, "cpu")
    ref = BA.solve_ba(cprob, ccam, cbf, iterations=3)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out[1].cpu().numpy(), ref[1].numpy(),
                               atol=1e-4)
    ref_mask = BA.classify_outliers(cprob, ccam, cbf, ref[0], ref[1])
    assert (out_mask.cpu() == ref_mask).float().mean().item() >= 0.995


def test_triangulate_pairs_on_the_card(cuda_device):
    """Keyframe a against 10 neighbours at 1024 slots: no host sync, the
    integer outputs identical to the CPU's, points within 1e-4 of their
    norm on >= 99% of valid rows."""
    from snakeslam_tpu_torch.ops.triangulate_pairs import (
        triangulate_pairs_batch)
    from snakeslam_tpu_torch.utils.backend_problems import pair_problem

    kw = pair_problem(1024, 10, 1, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = triangulate_pairs_batch(**kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = triangulate_pairs_batch(**pair_problem(1024, 10, 1, "cpu"))
    for k in ("valid", "match_b", "far_away", "n_new"):
        assert torch.equal(out[k].cpu(), ref[k]), k
    v = ref["valid"]
    assert int(v.sum()) > 1000
    err = (out["point"].cpu()[v] - ref["point"][v]).norm(dim=-1)
    close = err <= 1e-4 * ref["point"][v].norm(dim=-1)
    assert close.float().mean().item() >= 0.99


# ---------------------------------------------------------------------------
# the system glue's callers of the pose kernel and device ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [(4, 3), (3, 3)])
def test_kernel_large_batch(cuda_device, iters):
    """B = 320 problems in one launch (the realign's batch, 4 x 3 GN
    rounds; loop verification's 3 x 3): the batched launch equals single
    launches bit for bit; against the plain version, inlier agreement and
    counts as above, poses within 2e-4 where the two keep the same inlier
    set.  Where a feature's chi2 sits on its threshold the two may classify
    it apart and the later rounds then solve another problem: the plain
    version alone moves such a pose by up to ~2e-2 under a 1-ulp change of
    its inputs, so those problems (<= 2% of the batch) are counted, not
    compared."""
    outer, inner = iters
    probs = [pose_problem(700 + k, 1024, k % 3 != 0, cuda_device)[0]
             for k in range(320)]
    args = _stack(probs)
    kw = dict(outer_iters=outer, inner_iters=inner)
    launches = PF.LAUNCHES
    T, inl, n = PF.pose_refine_fused(*args, **kw)
    assert PF.LAUNCHES == launches + 1
    T2, _, _ = PF.pose_refine_fused(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(T, T2), "reruns must be bit-identical"
    for k in (0, 157, 319):
        Tk, ik, nk = PF.pose_refine_fused(*probs[k], **kw)
        assert torch.equal(Tk, T[k]) and torch.equal(ik, inl[k])
        assert int(nk) == int(n[k])
    Tr, ir, nr = PF.pose_refine_fused_reference(*args, **kw)
    assert (inl == ir).float().mean().item() > 0.99
    assert ((n - nr).abs() <= torch.clamp(nr // 100, min=3)).all()
    err = (T - Tr).abs().amax(dim=(1, 2))
    same = (inl == ir).all(dim=-1)
    assert err[same].max().item() <= 2e-4
    assert int((~same).sum()) <= 6


def test_pgo_and_sim3_ransac_on_the_card(cuda_device):
    """The loop closure's device solves: ``solve_pgo`` (float64) and
    ``sim3_ransac`` with no host sync (its threefry draw on the card
    included), the PGO bit-identical on a rerun and within 1e-8 of the CPU;
    the RANSAC's draw equal to the CPU's, its polished Sim3 within 1e-4 of
    the CPU's with the same inliers."""
    from snakeslam_tpu_torch.core import lie, prng
    from snakeslam_tpu_torch.ops import pgo as PGO
    from snakeslam_tpu_torch.ops import sim3_solver as SIM3

    rng = np.random.default_rng(3)
    V = 40
    true = [lie.se3_exp(torch.tensor(np.r_[rng.normal(size=3) * 2,
                                           rng.normal(size=3) * 0.3]))
            for _ in range(V)]
    poses = torch.stack([lie.se3_exp(torch.tensor(
        rng.normal(size=6) * 0.01)) @ T for T in true])
    ei = np.r_[np.arange(V - 1), 0, 5]
    ej = np.r_[np.arange(1, V), V - 1, 30]
    eT = torch.stack([true[j] @ torch.linalg.inv(true[i])
                      for i, j in zip(ei, ej)])
    fixed = torch.zeros(V, dtype=torch.bool)
    fixed[0] = True
    E = len(ei)
    graph = PGO.PoseGraph(poses, fixed, torch.ones(V, dtype=torch.bool),
                          torch.tensor(ei), torch.tensor(ej), eT,
                          torch.ones(E, dtype=torch.float64),
                          torch.ones(E, dtype=torch.bool))
    g_dev = PGO.PoseGraph(*(t.to(cuda_device) for t in graph))
    src = rng.uniform(-3, 3, size=(300, 3)) + [0, 0, 6]
    R = lie.so3_exp(torch.tensor([0.1, -0.2, 0.3])).numpy()
    dst = src @ R.T + [0.3, -0.1, 0.2] + rng.normal(size=src.shape) * 0.005
    dst[:90] += rng.uniform(0.5, 2.0, size=(90, 3))
    src32, dst32 = (torch.from_numpy(x.astype(np.float32))
                    for x in (src, dst))
    mask = torch.ones(300, dtype=torch.bool)
    on_card = [t.to(cuda_device) for t in (src32, dst32, mask)]
    key = prng.PRNGKey(7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = PGO.solve_pgo(g_dev, iterations=25)
        again = PGO.solve_pgo(g_dev, iterations=25)
        idx = prng.sample_without_replacement(key, on_card[2], 128, 3)
        rs = SIM3.sim3_ransac(*on_card, idx, threshold=0.05,
                              with_scale=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    ref = PGO.solve_pgo(graph, iterations=25)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].numpy(),
                               atol=1e-8)
    idx_cpu = prng.sample_without_replacement(key, mask, 128, 3)
    assert torch.equal(idx.cpu(), idx_cpu)
    rc = SIM3.sim3_ransac(src32, dst32, mask, idx_cpu, threshold=0.05,
                          with_scale=False)
    assert torch.equal(rs[3].cpu(), rc[3]) and int(rs[4]) >= 200
    for a, b in zip(rs[:3], rc[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


def test_mono_init_on_a_card_system_initializes_as_the_cpu(cuda_device):
    """A card system's monocular initializer runs its two-view geometry on
    the host (the card's f32 eigensolver scored 249 of 256 hypotheses
    otherwise on the mono-VI lane): on the small mono-VI twin's first
    frames, the same attempts with the same inlier counts, the same landing
    frame and the second keyframe's pose within 1e-4."""
    from snakeslam_tpu_torch.core import prng
    from snakeslam_tpu_torch.loop import loop_closing
    from snakeslam_tpu_torch.tracking import mono_init
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils import lane_trace as LT
    from snakeslam_tpu_torch.utils import vi_problems as VP

    out, devices = {}, []
    inner = mono_init.essential_ransac

    def on_host(*a, **k):
        devices.append(a[0].device.type)
        return inner(*a, **k)

    mono_init.essential_ransac = on_host
    try:
        for d in ("cpu", cuda_device):
            system, frames = VP.build_lane(d, **dict(VP.SMALL, n_frames=6))
            with prng.x64(True), LT.LaneTrace(system, mono_init,
                                              loop_closing) as rec:
                WindowedRunner(system, window=VP.SMALL_WINDOW).run(frames)
            m = system.map
            out[str(d)] = (rec.trace, m.kf_pose[m.valid_keyframes()].copy())
    finally:
        mono_init.essential_ransac = inner
    (tc, pc), (tg, pg) = out["cpu"], out[str(cuda_device)]
    assert tg["attempts"] == tc["attempts"] and tc["attempts"]
    assert tg["landed"]["mono_init"] == tc["landed"]["mono_init"] is not None
    assert set(devices) == {"cpu"}
    assert pg.shape == pc.shape and np.abs(pg - pc).max() < 1e-4


# ---------------------------------------------------------------------------
# the monocular visual-inertial path
# ---------------------------------------------------------------------------

def test_pose_kernel_on_the_mono_vi_lanes_problems(cuda_device):
    from snakeslam_tpu_torch.models import window_step as WS
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils import vi_problems as VP

    system, frames = VP.build_lane(cuda_device,
                                   **dict(VP.SMALL, n_frames=72))
    sol = system.imu_solver
    captured = {}
    inner = WS.pose_refine_fused

    def capture(*a, **k):
        if sol.gravity_initialized:
            captured[(k["outer_iters"], k["inner_iters"])] = (a, k)
        return inner(*a, **k)

    # eagerly: a replay of the window's graph runs no Python, so the
    # problems are read from the eager run (the graph replays its bits)
    with pytest.MonkeyPatch.context() as mp, graphs.disabled():
        mp.setattr(WS, "pose_refine_fused", capture)
        launches = PF.LAUNCHES
        runner = WindowedRunner(system, window=VP.SMALL_WINDOW)
        runner.run(frames)
    assert sol.gyro_initialized and sol.gravity_initialized
    assert PF.LAUNCHES - launches == \
        2 * VP.SMALL_WINDOW * runner.n_device_calls
    assert set(captured) == {(1, 3), (2, 2)}
    for (outer, inner_it), (a, kw) in captured.items():
        assert bool((a[3] <= 0).all()), "a mono lane has no stereo rows"
        assert int(a[5].sum()) >= 25
        T, inl, n = PF.pose_refine_fused(*a, **kw)
        T2, inl2, n2 = PF.pose_refine_fused(*a, **kw)
        assert torch.equal(T, T2) and torch.equal(inl, inl2)
        assert torch.equal(n, n2)
        Tr, ir, nr = PF.pose_refine_fused_reference(*_batch(a), **kw)
        _check_pose(T[None], inl[None], n[None], Tr, ir, nr)


def test_window_track_with_imu_on_the_card(cuda_device):
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu_torch.models import window_step as WS
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils import vi_problems as VP
    from snakeslam_tpu_torch.utils.imu_synthetic import (orbit_pose_wb,
                                                         synth_imu)
    from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld

    W, fps = 4, 10.0
    outs = {}
    for dev in ("cpu", cuda_device):
        world = SyntheticWorld(n_points=1500, seed=5)
        s = Settings()
        s.input_type = InputType.Stereo
        s.enable_imu = True
        s.feature_slots = 512
        s.local_map_slots = 1024
        s.pin_local_map_bucket = True
        s.th_depth = 25.0
        apply_world_to_settings(world, s)
        system = SlamSystem(s, dev)
        imu = synth_imu(orbit_pose_wb, 0.0, (W + 1) / fps, rate=200.0,
                        bg=VP.BG_TRUE, gyro_noise=1e-4, acc_noise=1e-3)
        traj = ((i / fps, VP.orbit_pose_cw(i / fps)) for i in range(W + 1))
        frames = list(synthetic_frames(world, traj, s, imu=imu))
        system.process_frame(frames[0])
        system.imu_solver.gyro_initialized = True
        system.imu_solver.bg = VP.BG_TRUE.copy()
        runner = WindowedRunner(system, window=W)
        assert runner._use_imu()
        lm, lm_ids, lm_gen = runner._local_map()
        t = system.tracker
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=system.device)
        carry = (f32(t.last_frame.pose_cw), f32(np.eye(4)),
                 f32(runner._initial_dec_state()),
                 torch.zeros((), dtype=torch.bool, device=system.device))
        scal = dict(kfi_target=f32(s.kfi_target_matches),
                    is_stereo=torch.tensor(True, device=system.device),
                    th_depth=f32(s.th_depth))
        launches = PF.LAUNCHES
        item, _ = runner._dispatch(frames, 1, W, lm, lm_ids, lm_gen, carry,
                                   scal)
        outs[str(dev)] = [np.asarray(a) for a in item.fetch()]
        if dev != "cpu":
            assert PF.LAUNCHES - launches == 2 * W
    (oc, ac, vc, fc), (og, ag, vg, fg) = outs["cpu"], outs[str(cuda_device)]
    assert (oc[:, 17] > 0.5).all()
    np.testing.assert_allclose(og[:, :16], oc[:, :16], atol=1e-4)
    assert np.array_equal(og[:, 17:20], oc[:, 17:20])
    assert (ag == ac).mean() >= 0.99
    for k in range(W):
        assert abs(int(og[k, 16]) - int(oc[k, 16])) <= max(3, oc[k, 16] // 100)


@pytest.mark.parametrize("K,n_kf", [(16, 12), (64, 60)])
def test_imu_solvers_on_the_card(cuda_device, K, n_kf):
    from snakeslam_tpu_torch.ops import imu as IMU
    from snakeslam_tpu_torch.utils import vi_problems as VP

    arrays = VP.chain_arrays(n_kf, K)
    arrays.pop("v_true")
    res = {}
    for dev in ("cpu", cuda_device):
        t = {k: torch.from_numpy(np.ascontiguousarray(
            a if a.dtype == bool else a.astype(np.float64))).to(dev)
            for k, a in arrays.items()}
        vec = lambda *x: torch.tensor(x, dtype=torch.float64, device=dev)
        sg = IMU.solve_scale_gravity(
            t["R"], t["p"], t["dt"][:-1], t["dt"][1:], t["dp"][:-1],
            t["dp"][1:], t["dv"][:-1],
            torch.arange(K - 2, device=dev) < n_kf - 2)
        ch = IMU.solve_imu_chain(
            IMU.ImuChain(**t), vec(0, 0, 0), vec(0, 0, 0),
            vec(0.3, -0.2, -9.71), vec(1.2)[0], solve_scale=True,
            iterations=4, prior_bias_weight=10.0)
        res[str(dev)] = [x.cpu().numpy() for x in sg] + \
            [ch[k].cpu().numpy() for k in ("v", "bg", "ba", "g", "s")]
    for a, b in zip(res["cpu"], res[str(cuda_device)]):
        np.testing.assert_allclose(b, a, atol=1e-9)
    assert abs(float(res["cpu"][0]) - 2.0) < 0.1


def _lane_depths(tmp_path, n: int, scale: float = 0.5):
    """The rendered TUM lane's first ``n`` depth frames, as the reader
    gives them, with their world->camera poses."""
    from snakeslam_tpu_torch.frontend.datasets import TumRgbdDataset
    from snakeslam_tpu_torch.utils import tum_fixture as TF

    traj = TF.lane_trajectory(n)
    TF.write_tum_fixture(tmp_path, TF.lane_world(scale=scale), traj)
    return [r.depth for r in TumRgbdDataset(tmp_path)], [T for _, T in traj]


@pytest.mark.parametrize("radius", [0, 2])
def test_depth_filter_on_the_card(cuda_device, tmp_path, radius):
    """The RGB-D depth filter on the card against the CPU: the kept pixels
    identical, depths within 1e-5 relative (the lane's rendered depth with
    flying pixels and holes added)."""
    from snakeslam_tpu_torch.frontend.depth_processor import process_depth

    depths, _ = _lane_depths(tmp_path, 3)
    rng = np.random.default_rng(radius)
    for d in depths:
        d = d.astype(np.float32)
        fly = rng.random(d.shape) < 0.01
        d[fly] = rng.uniform(0.3, 9.0, int(fly.sum()))
        d[rng.random(d.shape) < 0.02] = 0.0
        t = torch.from_numpy(d)
        c = process_depth(t, 40.0, gauss_radius=radius).numpy()
        g = process_depth(t.to(cuda_device), 40.0,
                          gauss_radius=radius).cpu().numpy()
        assert np.array_equal(g > 0, c > 0) and (c > 0).mean() > 0.2
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=0)


def test_tsdf_on_the_card(cuda_device, tmp_path):
    """TSDF integration of the lane's first frames on the card against the
    CPU: TSDF within 1e-5, weights equal, the same surface points."""
    from snakeslam_tpu_torch.ops import tsdf as TT
    from snakeslam_tpu_torch.utils import tum_fixture as TF

    depths, poses = _lane_depths(tmp_path, 4)
    vols = {}
    for dev in ("cpu", cuda_device):
        v = TT.create_volume(64, extent=6.0, origin=(-3.0, -3.0, -3.0),
                             device=dev)
        for d, T in zip(depths, poses):
            v = TT.integrate(v, torch.from_numpy(d), torch.from_numpy(T),
                             TF.FR1["fx"] / 2, TF.FR1["fy"] / 2,
                             TF.FR1["cx"] / 2, TF.FR1["cy"] / 2, 0.15)
        vols[str(dev)] = v
    c, g = vols["cpu"], vols[str(cuda_device)]
    np.testing.assert_allclose(g.tsdf.cpu().numpy(), c.tsdf.numpy(),
                               atol=1e-5, rtol=0)
    assert torch.equal(g.weight.cpu(), c.weight)
    pc, pg = TT.extract_surface_points(c), TT.extract_surface_points(g)
    assert len(pc) > 100 and np.array_equal(pg, pc)


def test_async_pipeline_on_the_card(cuda_device, tmp_path):
    """Async mode on the card: the producer thread runs ORB (FAST kernel
    launches), tracking and the async local BA run beside it; the launch
    counts stay exact and the run tracks."""
    from snakeslam_tpu_torch.frontend.datasets import TumRgbdDataset
    from snakeslam_tpu_torch.frontend.input import Input
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.utils import tum_fixture as TF

    traj = TF.lane_trajectory(64)[::4]
    TF.write_tum_fixture(tmp_path, TF.lane_world(scale=0.5), traj)
    s = Settings()
    s.input_type = InputType.RGBD
    s.enable_imu = False
    s.async_mode = s.async_lba = True
    s.fd_features, s.fd_levels = 500, 2
    s.width, s.height = 320, 240
    s.fx, s.fy = TF.FR1["fx"] / 2, TF.FR1["fy"] / 2
    s.cx, s.cy = TF.FR1["cx"] / 2, TF.FR1["cy"] / 2
    s.bf = TF.FR1_BF
    inp = Input(s, dataset=TumRgbdDataset(tmp_path), device=cuda_device)
    system = SlamSystem(s, cuda_device)
    fast0, pose0 = OK.FAST_LAUNCHES, PF.LAUNCHES
    system.run(iter(inp))
    assert len(system.tracker.trajectory) == len(traj)
    assert OK.FAST_LAUNCHES - fast0 == 2 * len(traj)
    assert PF.LAUNCHES - pose0 == 2      # finalize's two realigns
    assert system.lba.n_runs >= 1


def _sharded_ba(n_shards, device, dtype=torch.float64):
    """The sharded BA step (3 iterations) on a synthetic problem (C = 16,
    P = 1024, M = 8, seed 3) over ``n_shards`` shards of ``device``."""
    from snakeslam_tpu_torch.core.camera import Pinhole
    from snakeslam_tpu_torch.parallel import multichip as MC
    from snakeslam_tpu_torch.utils.ba_fixtures import (
        make_synthetic_ba_problem)

    mesh = MC.make_mesh(n_shards, device)
    home = mesh.devices[0]
    problem, _, _ = make_synthetic_ba_problem(C=16, P=1024, M=8, seed=3,
                                              device=home, dtype=dtype)
    cam = Pinhole.create(458.654, 457.296, 367.215, 248.375, device=home,
                         dtype=dtype)
    bf = torch.tensor(458.654 * 0.11, dtype=dtype, device=home)
    step = MC.sharded_ba_step(mesh, cam, bf, n_iters=3)
    return mesh, step, MC.shard_problem(problem, mesh)


def test_sharded_ba_step_on_the_card(cuda_device):
    """Four shards on one card (float64): no host sync, a rerun
    bit-identical, within 1e-9 of the same four shards on the CPU; the
    sharded matcher equal to the unsharded minimum and first index."""
    from snakeslam_tpu_torch.ops.descriptors import hamming_matrix
    from snakeslam_tpu_torch.parallel import multichip as MC

    mesh, step, shards = _sharded_ba(4, cuda_device)
    assert mesh.size == 4 and not mesh.distinct
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(shards)
        again = step(shards)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(out, again):
        assert a.device == mesh.devices[0]
        assert torch.equal(a, b), "rerun not bit-identical"
    _, cstep, cshards = _sharded_ba(4, "cpu")
    ref = cstep(cshards)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-9 * max(1.0, r.abs().max().item()))

    g = torch.Generator().manual_seed(0)
    pb = torch.randint(0, 2, (4096, 256), generator=g, dtype=torch.int8)
    fb = torch.randint(0, 2, (1024, 256), generator=g, dtype=torch.int8)
    d, idx = MC.sharded_hamming_topk(mesh)(pb.to(cuda_device),
                                           fb.to(cuda_device))
    H = hamming_matrix(pb, fb)
    assert torch.equal(d.cpu(), H.amin(dim=1))
    assert torch.equal(idx.cpu(), H.argmin(dim=1).to(torch.int32))


def test_sharded_ba_step_on_distinct_cards(cuda_device):
    """One shard a card (needs two or more cards): the reduce crosses
    cards, the result lands on the first card, bit-identical on a rerun
    and within 1e-9 of the same shards on the CPU."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh, step, shards = _sharded_ba(n, cuda_device)
    assert mesh.distinct
    assert [s.points.device for s in shards] == list(mesh.devices)
    out = step(shards)
    again = step(shards)
    for a, b in zip(out, again):
        assert a.device == torch.device("cuda", 0)
        assert torch.equal(a, b), "rerun not bit-identical"
    _, cstep, cshards = _sharded_ba(n, "cpu")
    ref = cstep(cshards)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-9 * max(1.0, r.abs().max().item()))


# ---------------------------------------------------------------------------
# the graph layer
# ---------------------------------------------------------------------------

GRAPH_W = 8


def _window_program_inputs(device):
    """A stereo map initialized on ``device`` and the window program's
    arguments for the next ``GRAPH_W`` frames (the last one tail padding,
    a refreshed median depth)."""
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu_torch.models import window_step as WS
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    world = SyntheticWorld(n_points=1500, seed=7)
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 512
    s.local_map_slots = 1024
    s.pin_local_map_bucket = True
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    system = SlamSystem(s, device)
    frames = list(synthetic_frames(
        world, orbit_trajectory(GRAPH_W + 1, radius=7.0, arc=0.04,
                                fps=200.0), s))
    for f in frames:
        f.timestamp = f.frame_id / 5.0
    system.process_frame(frames[0])
    runner = WindowedRunner(system, window=GRAPH_W)
    lm, _, _ = runner._local_map()
    t = system.tracker
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    dec = runner._initial_dec_state()
    args = (lm, f32(WS.pack_frames_np(frames[1:], 512)),
            f32(t.last_frame.pose_cw), f32(t.velocity), f32(dec),
            torch.zeros((), dtype=torch.bool, device=device), t.cam, t.bf,
            t.bounds, t.scales, t.log_sf, t.coarse_radius, t.fine_th)
    kw = dict(kfi_target=f32(s.kfi_target_matches),
              is_stereo=torch.tensor(True, device=device),
              th_depth=f32(s.th_depth),
              n_valid_frames=torch.tensor(GRAPH_W - 1, dtype=torch.int32,
                                          device=device),
              med_override=f32(1.5 * dec[8]), n_slots=512, two_stage=True)
    return WS.window_track, args, kw


_CASES: dict = {}


def _program_inputs(name, device):
    from snakeslam_tpu_torch.entry import entry
    from snakeslam_tpu_torch.models import tracking_step as TS
    from snakeslam_tpu_torch.optim import lba as LBA
    from snakeslam_tpu_torch.utils import graph_cases as GC
    from snakeslam_tpu_torch.utils.backend_problems import ba_problem

    if name == "window_track":
        return _window_program_inputs(device)
    if name in QUEUE_D_PROGRAMS:
        if device not in _CASES:
            _CASES[device] = GC.program_cases(device)
        return _CASES[device][name]
    _, args = entry(device)
    if name == "fine_step":
        return TS.fine_step, args, {}
    if name == "coarse_step":
        lm, frame, eye, _, _, cam, bf, bounds, scales, log_sf, th, _, w, _ = \
            args
        return (TS.coarse_step,
                (lm, frame, eye, cam, bf, bounds, scales, log_sf, th, w, w),
                dict(use_rotation_hist=True))
    prob, cam, bf = ba_problem(32, 1024, 8, 0, device)
    return LBA.solve_window, (prob, cam, bf), dict(iterations=3)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.cpu().numpy()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [a for v in tree for a in _host(v)]


def _same_bits(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


QUEUE_D_PROGRAMS = ("orb", "orb_batch", "stereo_frontend",
                    "imu_chain_solve", "triangulate_pool", "fuse_pool",
                    "fuse_pool_row", "fuse_search_single", "gba_full_ba",
                    "gba_point_ba", "gba_outliers", "pgo")


@pytest.mark.parametrize("name", ["window_track", "coarse_step",
                                  "fine_step", "lba_solve",
                                  *QUEUE_D_PROGRAMS])
def test_graph_replays_equal_the_eager_run(cuda_device, name):
    prog, args, kw = _program_inputs(name, cuda_device)
    prog.clear()
    c0, r0 = prog.captures, prog.replays
    first = _host(prog(*args, **kw))          # eager warm-up, then capture
    replay = _host(prog(*args, **kw))
    rerun = _host(prog(*args, **kw))
    with graphs.disabled():
        eager = _host(prog(*args, **kw))
    assert (prog.captures - c0, prog.replays - r0) == (1, 2)
    assert _same_bits(first, eager)
    assert _same_bits(replay, eager)
    assert _same_bits(rerun, replay)
    stats = graphs.stats()[prog.name]
    assert stats["entries"] == 1 and stats["pool_mib"] > 0


def test_launch_counts_read_replays(cuda_device):
    prog, args, kw = _window_program_inputs(cuda_device)
    prog.clear()
    for _ in range(3):     # the capture's eager warm-up, then two replays
        n0 = PF.LAUNCHES
        prog(*args, **kw)
        assert PF.LAUNCHES - n0 == 2 * GRAPH_W
    entry, = prog.entries()
    assert entry.replays == 2
    assert list(entry.tally.values()) == [2 * GRAPH_W]
    # ORB: the FAST kernel's launches (one a pyramid level) counted from
    # the replays of its graph
    orb, args, kw = _program_inputs("orb", cuda_device)
    orb.clear()
    for _ in range(3):
        n0 = OK.FAST_LAUNCHES
        orb(*args, **kw)
        assert OK.FAST_LAUNCHES - n0 == kw["levels"]
    entry, = orb.entries()
    assert entry.replays == 2
    assert list(entry.tally.values()) == [kw["levels"]]


def test_by_reference_graph_reads_its_table_and_goes_with_it(cuda_device):
    import gc

    def gather(table, rows):
        return table[rows] * 2.0

    prog = graphs.compiled(gather, by_ref=("table",), name="gather_by_ref")
    table = torch.arange(12.0, device=cuda_device).reshape(6, 2)
    rows = torch.tensor([4, 1], device=cuda_device)
    assert torch.equal(prog(table, rows), gather(table, rows))   # capture
    table.add_(1.0)
    # the replay reads the table where it lies, as it is now
    assert torch.equal(prog(table, rows), gather(table, rows))
    assert (prog.captures, prog.replays) == (1, 1)
    other = table.clone()
    assert torch.equal(prog(other, rows), gather(other, rows))
    assert len(prog.entries()) == 2          # another address, another graph
    del table
    gc.collect()
    assert len(prog.entries()) == 1          # the freed table's graph is gone
    assert torch.equal(prog(other, rows), gather(other, rows))
    assert prog.replays == 2


def test_a_program_keeps_its_most_recent_graphs(cuda_device):
    prog = graphs.compiled(lambda x: x * 2.0, max_entries=2, name="lru")
    xs = [torch.arange(float(n), device=cuda_device) for n in (3, 4, 5)]
    for x in xs[:2]:
        prog(x)                                   # two captures
    prog(xs[0])                                   # 3 is now the most recent
    prog(xs[2])                                   # drops 4, not 3
    assert (prog.captures, prog.replays, prog.evictions) == (3, 1, 1)
    keys = list(prog._entries)
    assert keys == [prog.key(xs[0]), prog.key(xs[2])]
    assert torch.equal(prog(xs[1]), xs[1] * 2.0)  # captured again
    assert prog.captures == 4 and len(prog.entries()) == 2


def test_clone_programs_share_one_pool_and_keep_their_outputs(cuda_device):
    def scale(x, k):
        return (x * k).cumsum(0)

    shared = graphs.compiled(scale, clone=True, name="shared_pool")
    private = graphs.compiled(scale, name="private_pools")
    xs = [torch.rand(n, device=cuda_device) for n in (1000, 3000, 2000)]
    k = torch.full((), 3.0, device=cuda_device)
    for prog in (shared, private):
        for x in xs:
            prog(x, k)                            # captures
        outs = [prog(x, k) for x in xs for _ in range(2)]   # replays
        for i, x in enumerate(xs):
            ref = scale(x, k)
            assert torch.equal(outs[2 * i], ref)
            assert torch.equal(outs[2 * i + 1], ref)
    assert len({tuple(e.graph.pool()) for e in shared.entries()}) == 1
    assert len({tuple(e.graph.pool()) for e in private.entries()}) == 3
    # a clone's outputs are its own: the next replay leaves them be
    a = shared(xs[0], k)
    shared(xs[0], torch.full((), 5.0, device=cuda_device))
    assert torch.equal(a, scale(xs[0], k))
    # with every graph of the pool dropped, the next capture takes a new one
    pool = shared.entries()[0].graph.pool()
    shared.clear()
    assert torch.equal(shared(xs[1], k), scale(xs[1], k))
    assert torch.equal(shared(xs[1], k), scale(xs[1], k))
    assert shared.entries()[0].graph.pool() != pool


def test_worker_captures_while_the_main_thread_replays(cuda_device):
    import threading

    win, wargs, wkw = _window_program_inputs(cuda_device)
    lba, largs, lkw = _program_inputs("lba_solve", cuda_device)
    win.clear()
    lba.clear()
    win(*wargs, **wkw)                     # the main thread's capture
    with graphs.disabled():
        w_eager = _host(win(*wargs, **wkw))
        l_eager = _host(lba(*largs, **lkw))
    go, done, out = threading.Event(), threading.Event(), {}

    def worker():
        try:
            go.wait(timeout=60)
            out["first"] = _host(lba(*largs, **lkw))     # capture here
            out["replay"] = _host(lba(*largs, **lkw))
            out["thread"] = threading.get_ident()
        finally:
            done.set()

    t = threading.Thread(target=worker)
    t.start()
    go.set()
    replays = []
    while not done.is_set() or len(replays) < 3:
        replays.append(_host(win(*wargs, **wkw)))
    t.join(timeout=60)
    assert not t.is_alive()
    assert all(_same_bits(r, w_eager) for r in replays)
    assert _same_bits(out["first"], l_eager)
    assert _same_bits(out["replay"], l_eager)
    entry, = lba.entries()
    assert entry.thread == out["thread"] != threading.get_ident()
    assert entry.replays == 1


def test_failed_capture_raises_without_an_eager_rerun(cuda_device):
    """A program with a host sync cannot be captured: the call raises
    GraphError naming it, and the eager version runs only as the warm-up
    (in a process of its own: a failed capture is left behind in it)."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import torch
from snakeslam_tpu_torch.utils import graphs
calls = []
def synced(x):
    calls.append(1)
    return x * float(x.sum())     # a host sync: not capturable
prog = graphs.compiled(synced, name="synced")
x = torch.ones(4, device="cuda")
for attempt in (1, 2):
    try:
        prog(x)
    except graphs.GraphError as e:
        assert "synced" in str(e) and "capture failed" in str(e), e
    else:
        raise SystemExit("no GraphError")
    # the warm-up and the capture attempt; nothing reran the eager version
    assert len(calls) == 2 * attempt, calls
    assert not prog.entries()
print("raised")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=Path(__file__).resolve().parent.parent)
    assert p.returncode == 0 and "raised" in p.stdout, p.stderr[-3000:]
