"""The stereo slice with the full keyframe back-end: the port against the
JAX package.

Both packages run tests/test_torch_slice.py's dense-keyframe configuration
(1500-point world, seed 7, 48 frames, timestamp = frame_id / 10,
feature_slots 512, window 8) with every back-end of the keyframe cycle —
triangulation, neighbour fusion, local BA, loop closing, simplification
(delay 8) and the deferred mapper (delay 9) — the JAX runner pinned to
the port's one-window-per-fetch schedule (see tests/test_torch_slice.py).

Tolerances: tracked, keyframe and LBA run counts equal; map points within
2%; ATE within 10% of the JAX run; per-frame camera centres within 1 mm.
"""

import numpy as np
import pytest

from test_torch_slice import (N_FRAMES, WINDOW, _centres, _frames,
                              _settings, jax_one_window_per_fetch)


def _run(pkg):
    if pkg == "jax":
        from snakeslam_tpu.frontend.synthetic_source import (
            apply_world_to_settings, synthetic_frames)
        from snakeslam_tpu.system.settings import InputType, Settings
        from snakeslam_tpu.system.slam import SlamSystem
        from snakeslam_tpu.tracking.windowed import WindowedRunner
        from snakeslam_tpu.utils.synthetic import (SyntheticWorld,
                                                   orbit_trajectory)
    else:
        from snakeslam_tpu_torch.frontend.synthetic_source import (
            apply_world_to_settings, synthetic_frames)
        from snakeslam_tpu_torch.system.settings import InputType, Settings
        from snakeslam_tpu_torch.system.slam import SlamSystem
        from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
        from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                         orbit_trajectory)
    world = SyntheticWorld(n_points=1500, seed=7)
    s = _settings(Settings, InputType, world, apply_world_to_settings)
    system = SlamSystem(s) if pkg == "jax" else SlamSystem(s, "cpu")
    frames = _frames(synthetic_frames, orbit_trajectory, world, s)
    with jax_one_window_per_fetch():   # the port's schedule; a no-op for it
        WindowedRunner(system, window=WINDOW).run(frames)
    return system


@pytest.fixture(scope="module")
def runs():
    return _run("jax"), _run("port")


def test_counts(runs):
    jax_sys, port_sys = runs
    assert len(jax_sys.tracker.trajectory) == N_FRAMES
    assert len(port_sys.tracker.trajectory) == N_FRAMES
    assert port_sys.map.n_keyframes == jax_sys.map.n_keyframes
    assert port_sys.lba.n_runs == jax_sys.lba.n_runs > 0
    assert (port_sys.loop_closing.n_loops_closed
            == jax_sys.loop_closing.n_loops_closed)
    # the keyframe-reduction back-end ran: keyframes were culled
    assert (port_sys.simplification.n_culled
            == jax_sys.simplification.n_culled > 0)


def test_point_count(runs):
    jax_sys, port_sys = runs
    nj, nt = jax_sys.map.n_points, port_sys.map.n_points
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)


def test_ate_and_camera_centres(runs):
    jax_sys, port_sys = runs
    ate_j, _, nj = jax_sys.ate_against_gt(with_scale=False)
    ate_t, _, nt = port_sys.ate_against_gt(with_scale=False)
    assert nj == nt == N_FRAMES
    assert abs(ate_t - ate_j) <= 0.1 * ate_j, (ate_t, ate_j)
    cj, ct = _centres(jax_sys), _centres(port_sys)
    assert cj.keys() == ct.keys()
    diff = max(np.linalg.norm(cj[k] - ct[k]) for k in cj)
    assert diff < 1e-3, f"max camera-centre difference {diff} m"


def test_map_is_consistent(runs):
    _, port_sys = runs
    assert port_sys.map.validate() == []
