"""``SlamSystem.finalize`` in both packages on the same input.

tests/test_finalize_mitigation.py's scenario (3000-point world, seed 11,
60 frames on an inward arc, a keyframe every 0.5 s of dense timestamps,
frame by frame through ``process_frame``; stereo without the IMU in both):
the last interior trailing keyframe's pose corrupted by (1.5, -1.0, 0.8)
m, then ``finalize(gba_iterations=3)``: the trailing-section mitigation,
the queues drained, full BA, outlier removal, rematch and realign.

Tolerances: the same keyframes before finalize, the corrupted one culled
in both, the same keyframes after, the port's ATE within 10% of the JAX
run's.
"""

import numpy as np


def _dense_run(pkg, n_frames=60, seed=11):
    if pkg == "jax":
        from snakeslam_tpu.frontend.synthetic_source import (
            apply_world_to_settings, synthetic_frames)
        from snakeslam_tpu.system.settings import InputType, Settings
        from snakeslam_tpu.system.slam import SlamSystem
        from snakeslam_tpu.utils.synthetic import (SyntheticWorld,
                                                   orbit_trajectory)
    else:
        from snakeslam_tpu_torch.frontend.synthetic_source import (
            apply_world_to_settings, synthetic_frames)
        from snakeslam_tpu_torch.system.settings import InputType, Settings
        from snakeslam_tpu_torch.system.slam import SlamSystem
        from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                         orbit_trajectory)
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.lba_cam_slots = 24
    s.lba_point_slots = 4096
    s.lba_obs_slots = 8
    s.th_depth = 25.0
    world = SyntheticWorld(n_points=3000, seed=seed)
    apply_world_to_settings(world, s)
    system = SlamSystem(s) if pkg == "jax" else SlamSystem(s, "cpu")
    frames = list(synthetic_frames(
        world, orbit_trajectory(n_frames, radius=7.0, arc=0.8), s,
        noise_px=0.3))
    for f in frames:
        f.timestamp = f.frame_id / 10.0
    for f in frames:
        system.process_frame(f)
    return system


def _interior_trailing(smap):
    valid = smap.valid_keyframes()
    order = valid[np.argsort(smap.kf_frame_id[valid])]
    last_fid = int(smap.kf_frame_id[order[-1]])
    return [int(k) for k in order[:-1]
            if smap.kf_frame_id[k] > last_fid - 30
            and smap.kf_prev[k] >= 0 and smap.kf_next[k] >= 0]


def test_finalize_matches_jax():
    runs = {pkg: _dense_run(pkg) for pkg in ("jax", "port")}
    jm, tm = runs["jax"].map, runs["port"].map
    np.testing.assert_array_equal(tm.valid_keyframes(), jm.valid_keyframes())
    bad = _interior_trailing(jm)[-1]
    assert _interior_trailing(tm)[-1] == bad
    for system in runs.values():
        system.map.kf_pose[bad][:3, 3] += np.array([1.5, -1.0, 0.8])
        system.finalize(gba_iterations=3)
    assert not jm.kf_valid[bad] and not tm.kf_valid[bad]
    np.testing.assert_array_equal(tm.valid_keyframes(), jm.valid_keyframes())
    ate_j, _, nj = runs["jax"].ate_against_gt(with_scale=False)
    ate_t, _, nt = runs["port"].ate_against_gt(with_scale=False)
    assert nt == nj >= 50
    assert abs(ate_t - ate_j) <= 0.1 * ate_j, (ate_t, ate_j)
    assert "ATE RMSE SE3" in runs["port"].map_statistics()
