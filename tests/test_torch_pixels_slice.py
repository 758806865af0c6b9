"""The pixels slice end to end: the port against the JAX package.

Both packages run tests/test_pixels_frontend.py's
``test_pixel_sequence_windowed_tracks`` configuration (900-point rendered
world, seed 3, 320x240, 48 frames, 600 features on 4 levels, chunk 16,
window 16) through ``PixelFrameSequence`` and ``WindowedRunner`` on the CPU,
both with the keyframe back-end reduced to its synchronous half (no
triangulation, fusion, local BA or loop / simplification / deferred-mapper
back-ends), and the JAX package's runner pinned to the port's
one-window-per-fetch schedule (see tests/test_torch_slice.py).

Tolerances: tracked counts equal, keyframes within 1, ATE within 20% of the
JAX run (the front-ends differ in a few descriptor bits,
tests/test_torch_pixels.py, which moves individual matches).
"""

import pytest

from test_torch_pixels import _render, _settings, _world
from test_torch_slice import jax_one_window_per_fetch

N_FRAMES, CHUNK, WINDOW = 48, 16, 16


def _slice_inputs(render_sequence, SyntheticWorld, orbit_trajectory):
    world = _world(SyntheticWorld, 900, 3)
    return _render(render_sequence, world,
                   orbit_trajectory(N_FRAMES, radius=6.5, arc=0.5, fps=20.0))


def _slice_settings(Settings, InputType):
    s = _settings(Settings, InputType)
    s.fd_features = 600
    s.fd_levels = 4
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.lba_cam_slots = 16
    s.lba_point_slots = 2048
    s.lba_obs_slots = 8
    s.th_depth = 20.0
    return s


@pytest.fixture(scope="module")
def slice_runs():
    """test_pixel_sequence_windowed_tracks' configuration (48 frames,
    chunk 16, window 16) through both packages."""
    from snakeslam_tpu.frontend.pixels import PixelFrameSequence as JSeq
    from snakeslam_tpu.system.settings import InputType as JIT
    from snakeslam_tpu.system.settings import Settings as JS
    from snakeslam_tpu.system.slam import SlamSystem as JSys
    from snakeslam_tpu.tracking.windowed import WindowedRunner as JRun
    from snakeslam_tpu_torch.frontend.pixels import PixelFrameSequence
    from snakeslam_tpu_torch.ops import orb_kernels
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
    from snakeslam_tpu_torch.utils.render_world import render_sequence
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    L, R, ts, gt = _slice_inputs(render_sequence, SyntheticWorld,
                                 orbit_trajectory)
    s = _slice_settings(JS, JIT)
    jax_sys = JSys(s)
    lm = jax_sys.local_mapper
    lm.lba = None
    lm.map_searcher = None
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None
    with jax_one_window_per_fetch():
        JRun(jax_sys, window=WINDOW, two_stage=True).run(
            JSeq(s, L, R, ts, gt, chunk=CHUNK))

    s = _slice_settings(Settings, InputType)
    port_sys = SlamSystem(s, "cpu")
    lm = port_sys.local_mapper
    lm.lba = None
    lm.map_searcher = None
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None
    seq = PixelFrameSequence(s, L, R, ts, gt, chunk=CHUNK, device="cpu")
    launches = orb_kernels.FAST_LAUNCHES
    WindowedRunner(port_sys, window=WINDOW).run(seq)
    return jax_sys, port_sys, orb_kernels.FAST_LAUNCHES - launches


def test_pixels_slice_matches_jax(slice_runs):
    jax_sys, port_sys, launches = slice_runs
    assert launches == 0          # CPU tensors: the plain FAST version
    tj, tp = (len(x.tracker.trajectory) for x in (jax_sys, port_sys))
    assert tp == tj >= int(0.9 * N_FRAMES), (tp, tj)
    kj, kp = jax_sys.map.n_keyframes, port_sys.map.n_keyframes
    assert abs(kp - kj) <= 1 and kp >= 2, (kp, kj)
    assert port_sys.map.n_points > 100
    ate_j = jax_sys.ate_against_gt(with_scale=False)[0]
    ate_p = port_sys.ate_against_gt(with_scale=False)[0]
    assert abs(ate_p - ate_j) <= 0.2 * ate_j, (ate_p, ate_j)
