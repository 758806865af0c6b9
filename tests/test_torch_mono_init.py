"""Monocular two-frame initialization: the port against the JAX package.

``feature_histogram_density`` is exact.  The gates: a texture-poor first
frame is refused, too few matches restart from the current frame, low flow
waits, and rotation-only motion never initializes although frame pairs
reach the RANSACs (tests/test_e2e_mono.py::test_mono_rejects_pure_rotation).
``try_initialize`` on tests/test_e2e_mono.py's orbit, each package drawing
its own RANSAC hypotheses from its own key: every attempt splits the same
keys, and the port's essential and homography draws equal the JAX
initializer's index for index (float64 draws, as JAX's under the tests'
x64; no hook); the same two keyframes, point count
within 2%, the second keyframe's pose within 1e-4 after the two-view BA
(float32 BA on both sides), median depth 3 within 1e-3 in both, the shared
points within 1e-3.  ``LocalBA.run`` commits on an unchanged map and drops
the whole commit when ``map.state`` changed since its snapshot.
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_twoview import _jax_samples

from snakeslam_tpu.tracking import mono_init as JM
from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.tracking import mono_init as TM


def _mk(rng, uv, fid):
    n = len(uv)
    return FrameData(
        frame_id=fid, timestamp=fid / 20.0, uv=uv,
        octave=np.zeros(n, np.int32), angle=np.zeros(n),
        descriptors=rng.integers(0, 256, (n, 32)).astype(np.uint8),
        right=np.full(n, -1.0), depth=np.full(n, -1.0))


def test_feature_histogram_density_exact(rng):
    s = Settings()
    for uv in (rng.uniform(0, 60, size=(300, 2)),
               rng.uniform((0, 0), (s.width, s.height), size=(300, 2)),
               rng.uniform((0, 0), (s.width, s.height), size=(7, 2)),
               np.zeros((0, 2))):
        for bin_px in (48, 64):
            assert TM.feature_histogram_density(
                uv, s.width, s.height, bin_px) == \
                JM.feature_histogram_density(uv, s.width, s.height, bin_px)


@pytest.mark.parametrize("q", [0, 1, 2])
def test_quality_presets_match(q):
    assert vars(TM.MonoInitSettings.for_quality(q)) == \
        vars(JM.MonoInitSettings.for_quality(q))


def test_first_frame_coverage_gate(rng):
    s = Settings()
    init = TM.MonoInitializer(s, "cpu")
    poor = _mk(rng, rng.uniform(0, 60, size=(300, 2)), 0)
    good = _mk(rng, rng.uniform((0, 0), (s.width, s.height), size=(300, 2)),
               1)
    assert init.try_initialize(None, poor) is False
    assert init.ref_frame is None
    assert init.try_initialize(None, good) is False
    assert init.ref_frame is good


def test_too_few_matches_restarts_and_low_flow_waits(rng):
    s = Settings()
    init = TM.MonoInitializer(s, "cpu")
    uv = rng.uniform((0, 0), (s.width, s.height), size=(400, 2))
    a = _mk(rng, uv, 0)
    b = _mk(rng, uv, 1)             # unrelated descriptors: no matches
    assert init.try_initialize(None, a) is False
    assert init.try_initialize(None, b) is False
    assert init.ref_frame is b      # restarted from the current frame
    c = _mk(rng, uv + 0.5, 2)       # the same features, half a pixel on
    c.descriptors = b.descriptors.copy()
    assert init.try_initialize(None, c) is False
    assert init.ref_frame is b and init.n_attempts == 0   # waits for flow


def _port_system(world_kw, slots=2048):
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings)
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld

    s = Settings()
    s.input_type = InputType.Mono
    s.feature_slots = 1024
    s.local_map_slots = slots
    s.lba_cam_slots, s.lba_point_slots, s.lba_obs_slots = 24, 4096, 8
    world = SyntheticWorld(**world_kw)
    apply_world_to_settings(world, s)
    return SlamSystem(s, "cpu"), world, s


def test_pure_rotation_never_initializes():
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        synthetic_frames)
    from snakeslam_tpu_torch.utils.synthetic import lookat_pose_cw

    system, world, s = _port_system(dict(n_points=2000, seed=3), slots=1024)

    def rot_only(n):
        eye = np.array([0.0, 0.0, -7.0])
        for i in range(n):
            a = 0.003 * i
            target = np.array([np.sin(a) * 5, 0.0, -7.0 + np.cos(a) * 5])
            yield i / 20.0, lookat_pose_cw(eye, target)

    for f in synthetic_frames(world, rot_only(15), s, noise_px=0.3):
        system.process_frame(f)
    assert system.map.n_keyframes == 0
    # the geometric gates refused it, not the flow gate alone
    assert system.tracker.mono_initializer.n_attempts > 0


@pytest.fixture(scope="module")
def initialized():
    """Both packages' systems after mono initialization on the same frames,
    each drawing its own hypotheses; the local BA after it is off in both.
    The RANSACs' keys and masks are recorded on both sides."""
    from snakeslam_tpu.frontend.synthetic_source import (
        apply_world_to_settings as j_apply)
    from snakeslam_tpu.map.slam_map import FrameData as JFrame
    from snakeslam_tpu.system.settings import InputType as JIT, \
        Settings as JSettings
    from snakeslam_tpu.system.slam import SlamSystem as JSystem
    from snakeslam_tpu.utils.synthetic import SyntheticWorld as JWorld
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        synthetic_frames)
    from snakeslam_tpu_torch.utils.synthetic import orbit_trajectory
    from snakeslam_tpu_torch.utils.vi_problems import frame_as

    tsys, world, s = _port_system(dict(n_points=3000, seed=11))
    js = JSettings()
    js.input_type = JIT.Mono
    js.feature_slots = 1024
    js.local_map_slots = 2048
    js.lba_cam_slots, js.lba_point_slots, js.lba_obs_slots = 24, 4096, 8
    j_apply(JWorld(n_points=3000, seed=11), js)
    jsys = JSystem(js)
    tsys.local_mapper.lba = None
    jsys.local_mapper.lba = None
    jinit = jsys.tracker.mono_initializer
    tinit = tsys.tracker.mono_initializer
    draws = {"port": [], "jax": []}

    def recording(module, name, side, key_pos=3):
        inner = getattr(module, name)

        def wrapped(*a, **k):
            draws[side].append((name, np.asarray(a[key_pos]).copy(),
                                np.asarray(a[2]), k["n_hypotheses"]))
            return inner(*a, **k)
        return wrapped

    frames = list(synthetic_frames(
        world, orbit_trajectory(30, radius=7.0, arc=0.9 * 30 / 50), s,
        noise_px=0.3))
    init_at = -1
    with contextlib.ExitStack() as stack:
        stack.enter_context(prng.x64(True))
        for mod, side in ((TM, "port"), (JM, "jax")):
            for name in ("essential_ransac", "homography_ransac"):
                stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                    mod, name, recording(mod, name, side))
        for f in frames:
            tsys.process_frame(f)
            jsys.process_frame(frame_as(f, JFrame))
            nt, nj = tsys.map.n_keyframes, jsys.map.n_keyframes
            assert nt == nj, f"frame {f.frame_id}: {nt} vs {nj} keyframes"
            np.testing.assert_array_equal(tinit.key, np.asarray(jinit.key))
            if nt >= 2:
                init_at = f.frame_id
                break
    assert 0 < init_at < 25
    return tsys, jsys, init_at, draws, tinit.n_attempts


def test_try_initialize_draws_the_jax_samples(initialized):
    """Every RANSAC of every attempt: the same key, the same mask, and the
    port's own draw equal to the JAX initializer's Gumbel top-k."""
    _, _, _, draws, n_attempts = initialized
    port, jax_ = draws["port"], draws["jax"]
    assert n_attempts >= 1 and len(port) == len(jax_) >= n_attempts
    size = dict(essential_ransac=8, homography_ransac=4)
    for (name, key, mask, n), (jname, jkey, jmask, jn) in zip(port, jax_):
        assert (name, n) == (jname, jn)
        np.testing.assert_array_equal(key, jkey)
        np.testing.assert_array_equal(mask, jmask)
        with prng.x64(True):
            got = prng.sample_without_replacement(
                key, torch.as_tensor(mask), n, size[name])
        np.testing.assert_array_equal(
            got.numpy(), _jax_samples(jkey, mask, n, size[name]))


def test_try_initialize_same_keyframes_and_pose(initialized):
    tsys, jsys, init_at, _, _ = initialized
    tm, jm = tsys.map, jsys.map
    kt, kj = tm.valid_keyframes(), jm.valid_keyframes()
    assert len(kt) == len(kj) == 2
    np.testing.assert_array_equal(tm.kf_frame_id[kt], jm.kf_frame_id[kj])
    assert abs(tm.n_points - jm.n_points) <= 0.02 * jm.n_points
    assert jm.n_points > 100
    np.testing.assert_allclose(tm.kf_pose[kt[0]], np.eye(4), atol=0)
    np.testing.assert_allclose(tm.kf_pose[kt[1]], jm.kf_pose[kj[1]],
                               atol=1e-4)


def test_try_initialize_median_depth_and_points(initialized):
    tsys, jsys, _, _, _ = initialized
    tm, jm = tsys.map, jsys.map
    for m in (tm, jm):
        z = m.pt_pos[m.valid_points()][:, 2]    # camera 1 is the world
        assert abs(np.median(z) - 3.0) < 1e-3
    # points by the first keyframe's feature that created them
    kf_t, kf_j = tm.valid_keyframes()[0], jm.valid_keyframes()[0]
    ft = {int(f): int(p) for f, p in enumerate(tm.kf_obs[kf_t]) if p >= 0}
    fj = {int(f): int(p) for f, p in enumerate(jm.kf_obs[kf_j]) if p >= 0}
    both = sorted(set(ft) & set(fj))
    assert len(both) >= 0.98 * len(fj)
    d = np.abs(tm.pt_pos[[ft[f] for f in both]]
               - jm.pt_pos[[fj[f] for f in both]])
    assert d.max() < 1e-3
    # the tracker is left as the JAX tracker is
    assert tsys.tracker.last_kf == tm.valid_keyframes()[1]
    assert len(tsys.tracker.trajectory) == len(jsys.tracker.trajectory)


def test_local_ba_run_drops_on_changed_state(initialized):
    from snakeslam_tpu_torch.optim.lba import LocalBA
    from snakeslam_tpu_torch.utils.loop_problems import clone_map

    tsys, _, _, _, _ = initialized
    kf2 = int(tsys.map.valid_keyframes()[1])

    def fresh():
        m = clone_map(tsys.map)
        return m, LocalBA(tsys.s, m, "cpu")

    m, lba = fresh()
    before = m.pt_pos.copy()
    lba.run(kf2)
    assert np.abs(m.pt_pos - before).max() > 0      # it commits

    m, lba = fresh()
    before, pose_before = m.pt_pos.copy(), m.kf_pose.copy()
    inner = lba.dispatch

    def dispatch_then_touch(kf, iterations=3):
        out = inner(kf, iterations)
        m.state += 1             # the map changed after the snapshot
        return out

    lba.dispatch = dispatch_then_touch
    lba.run(kf2)
    np.testing.assert_array_equal(m.pt_pos, before)
    np.testing.assert_array_equal(m.kf_pose, pose_before)
    lba.add(kf2)                 # the queue interface is the same call
    np.testing.assert_array_equal(m.pt_pos, before)
