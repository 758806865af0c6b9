"""Global BA, outlier removal, rematch and realign: the port against the JAX
package on one map.

The map is 10 stereo keyframes on the smooth lane's inward arc (radius
7 m, 0.6 rad; a 6000-point world, seed 7, 980 features a view), built by
``snakeslam_tpu_torch/utils/loop_problems.build_map`` (points at ground
truth; copied into each package's map), with 18
tracked non-keyframe frames between them: each observed at a third and two
thirds of the way to the next keyframe, its matches the ground-truth
associations, its pose the true one perturbed by ~5 mm and ~0.3 mrad, its
reference the preceding keyframe.  Before the BA tests the map's points move by ~5 mm of noise and
its keyframes by ~2 mm and ~0.2 mrad; for the outlier pass 40 points of
that map move by a further 0.5 m.  The same state is copied into both
packages.

Tolerances (the port solves the three BA passes in float64, the JAX
package in float32): full BA (3 iterations) poses within 1e-4 and points
within 1e-4 of their norm (the far points' depth is weakly constrained and
moves with float32 rounding); point BA points within 1e-4 of their norm, the
median within 1e-5; the same observations erased; rematch matches identical for every frame; realign
poses within 2e-4 and the same frames refined.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_fusion import _copy_map, _port_settings
from test_torch_loop import _jax_settings

from snakeslam_tpu.map.slam_map import FrameData as JFrame
from snakeslam_tpu.map.slam_map import SlamMap as JMap
from snakeslam_tpu_torch.map.slam_map import FrameData as TFrame
from snakeslam_tpu_torch.map.slam_map import SlamMap as TMap
from snakeslam_tpu_torch.utils import loop_problems as LP


def _se3(xi):
    from snakeslam_tpu_torch.core import lie
    import torch

    return lie.se3_exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()


N_KF = 10


def _arc_pose(x):
    """orbit_trajectory's pose (radius 7 m, looking at the origin) at the
    fraction x of a 0.6 rad arc."""
    from snakeslam_tpu.utils.synthetic import lookat_pose_cw

    a = 0.6 * x
    eye = np.array([7.0 * np.sin(a), 0.5 * np.sin(2.5 * a),
                    -7.0 * np.cos(a)])
    return lookat_pose_cw(eye, np.zeros(3))


def build_scene():
    """(map at ground truth, its noisy copy, the noisy copy with 40 gross
    outliers, JAX settings, frames)."""
    tmap, ts, world, pid_to_pt = LP.build_map(
        [_arc_pose(i / (N_KF - 1)) for i in range(N_KF)], n_points=6000,
        seed=7, max_features=1000)
    jmap, js = _copy_map(tmap, JMap), _jax_settings(ts)
    rng = np.random.default_rng(5)
    frames = []
    for i in range(N_KF - 1):
        for h in (1, 2):
            pose = _arc_pose((i + h / 3.0) / (N_KF - 1))
            sf = world.observe(pose, max_features=1000, noise_px=0.2,
                               n_clutter=20, with_stereo=True)
            f = LP.frame_from(sf, 1000 + 3 * i + h, cls=JFrame)
            f.matches = np.array([pid_to_pt.get(int(p), -1)
                                  for p in sf.point_id], dtype=np.int64)
            f.outlier = np.zeros(f.n, dtype=bool)
            noise = np.concatenate([rng.normal(size=3) * 5e-3,
                                    rng.normal(size=3) * 3e-4])
            f.pose_cw = _se3(noise) @ pose
            f.ref_kf = i
            f.capture_rel(jmap.kf_pose[i], jmap.kf_frame_id[i])
            frames.append(f)
    noisy = _copy_map(jmap, JMap)
    pts = noisy.valid_points()
    noisy.pt_pos[pts] += rng.normal(size=(len(pts), 3)) * 5e-3
    for k in noisy.valid_keyframes()[1:]:
        noise = np.concatenate([rng.normal(size=3) * 2e-3,
                                rng.normal(size=3) * 2e-4])
        noisy.kf_pose[k] = _se3(noise) @ noisy.kf_pose[k]
    gross = _copy_map(noisy, JMap)
    gross.pt_pos[rng.choice(pts, 40, replace=False)] += 0.5
    return jmap, noisy, gross, js, frames


@pytest.fixture(scope="module")
def scene():
    return build_scene()


def _port_frames(frames):
    # the port's frame has fields the JAX one lacks (match_gen): left unset
    # here, stamped by the caller as the port's tracker stamps them
    def value(jf, name):
        v = getattr(jf, name, None)
        return v.copy() if isinstance(v, np.ndarray) else v

    return [TFrame(**{f.name: value(jf, f.name)
                      for f in dataclasses.fields(TFrame)})
            for jf in frames]


def _gbas(m, js):
    from snakeslam_tpu.optim.gba import GlobalBA as JGBA
    from snakeslam_tpu_torch.optim.gba import GlobalBA as TGBA

    jm, tm = _copy_map(m, JMap), _copy_map(m, TMap)
    return (JGBA(js, jm), TGBA(_port_settings(js), tm, "cpu"), jm, tm)


def _assert_obs_equal(jm, tm):
    for name in ("kf_obs", "pt_valid", "pt_obs_kf", "pt_obs_feat",
                 "pt_n_obs"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)


def test_full_ba_matches_jax(scene):
    _, noisy, _, js, _ = scene
    jg, tg, jm, tm = _gbas(noisy, js)
    cj, ct = jg.full_ba(iterations=3), tg.full_ba(iterations=3)
    assert abs(ct - cj) <= 1e-4 * abs(cj)
    kfs = jm.valid_keyframes()
    np.testing.assert_allclose(tm.kf_pose[kfs], jm.kf_pose[kfs], atol=1e-4)
    pts = jm.valid_points()
    err = np.linalg.norm(tm.pt_pos[pts] - jm.pt_pos[pts], axis=1)
    assert (err <= 1e-4 * np.linalg.norm(jm.pt_pos[pts], axis=1)).all(), \
        err.max()
    # the solve lowered the cost (zero iterations: the cost it started at)
    assert ct < 0.5 * _gbas(noisy, js)[1].full_ba(iterations=0)


def test_point_ba_matches_jax(scene):
    _, noisy, _, js, _ = scene
    jg, tg, jm, tm = _gbas(noisy, js)
    jg.point_ba(iterations=4)
    tg.point_ba(iterations=4)
    pts = jm.valid_points()
    err = np.linalg.norm(tm.pt_pos[pts] - jm.pt_pos[pts], axis=1)
    assert (err <= 1e-4 * np.linalg.norm(jm.pt_pos[pts], axis=1)).all(), \
        err.max()
    assert np.median(err) < 1e-5


def test_remove_outliers_matches_jax(scene):
    _, _, gross, js, _ = scene
    jg, tg, jm, tm = _gbas(gross, js)
    rj, rt = jg.remove_outliers(), tg.remove_outliers()
    assert rt == rj > 40
    _assert_obs_equal(jm, tm)


def test_rematch_and_realign_match_jax(scene):
    truth, _, _, js, frames = scene
    jg, tg, jm, tm = _gbas(truth, js)
    jf = [dataclasses.replace(f) for f in frames]
    tf = _port_frames(frames)
    # stamped as SlamSystem.process_frame stamps a tracked frame: the
    # realign reads SlamMap.live_matches, as on every run of the port
    for f in tf:
        tm.stamp_matches(f)
        assert f.match_gen is not None
    nj = jg.realign_intermediate_frames(jf)
    nt = tg.realign_intermediate_frames(tf)
    assert nt == nj == len(frames)
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(b.pose_cw, a.pose_cw, atol=2e-4)
        gt = np.linalg.inv(a.gt_pose_cw)[:3, 3]
        assert np.linalg.norm(np.linalg.inv(b.pose_cw)[:3, 3] - gt) < 2e-3
    rj, rt = jg.rematch_intermediate(jf), tg.rematch_intermediate(tf)
    assert rt == rj > 0
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b.matches, a.matches)
        # the rematch stamps its new matches
        np.testing.assert_array_equal(
            b.match_gen, tm.pt_alloc_gen[np.maximum(b.matches, 0)])


def test_realign_drops_matches_of_reused_point_slots(scene):
    """A point erased after a frame was tracked frees its slot, and a later
    allocation reuses the slot for another point: the frame's match names
    that point now.  The port's realign drops such matches (the frame's
    ``match_gen`` stamp against ``pt_alloc_gen``) and refines exactly as
    with them unmatched; the JAX package's realign keeps them."""
    import copy

    truth, _, _, js, frames = scene
    _, tg, _, tm = _gbas(truth, js)
    f = _port_frames(frames)[4]
    tm.stamp_matches(f)
    # a third of the matched slots reused by points 2 cm away: within the
    # robust refine's inlier gate, so a kept match pulls the pose
    reused = np.unique(f.matches[f.matches >= 0])[:300]
    moved = tm.pt_pos[reused] + [0.02, 0.0, 0.0]
    for p in reused:
        tm.erase_point(int(p))
    for pos in moved[::-1]:     # the free list hands slots back LIFO
        tm.allocate_point(pos, np.zeros(32, np.uint8), 0, 7.0, 0,
                          np.zeros(3))
    np.testing.assert_array_equal(tm.pt_pos[reused], moved)
    live = tm.live_matches(f)
    hit = np.isin(f.matches, reused)
    assert hit.sum() >= 300 and not live[hit].any()
    assert live[~hit].sum() == (f.matches[~hit] >= 0).sum()
    unmatched = copy.deepcopy(f)
    unmatched.matches = np.where(hit, -1, f.matches)
    tm.stamp_matches(unmatched)
    stale = copy.deepcopy(f)
    stale.match_gen = None          # the JAX package's behaviour
    assert tg.realign_intermediate_frames([f, unmatched, stale]) == 3
    np.testing.assert_array_equal(f.pose_cw, unmatched.pose_cw)
    assert np.abs(stale.pose_cw - f.pose_cw).max() > 1e-3
