"""The port's map checkpoints, exports, chaos hooks, stereo rectification
and trajectory IO against the JAX package's.

One small stereo map (``utils/loop_problems.build_map`` over six outward
poses, its copy in the JAX package's ``SlamMap``): a checkpoint written by
either package loads in the other with every field, counter and free list
equal; ``export_scene`` writes equal arrays and ``write_ply`` equal bytes;
the same ``Chaos`` seed removes the same points, observations and
keyframes, and ``crazy_move`` moves both maps alike (1e-12).
``stereo_rectify`` on an EuRoC-like rig, with and without distortion,
agrees with the JAX one (1e-9).  ``core/trajectory.py``: ``write_tum`` files
equal byte for byte, ``read_tum``, ``umeyama``, ``ate_rmse`` and
``associate`` agree.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snakeslam_tpu.core import lie as jlie
from snakeslam_tpu.core import trajectory as JTR
from snakeslam_tpu.core.camera import Distortion as JDistortion
from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.frontend.stereo_rectify import stereo_rectify as j_rectify
from snakeslam_tpu.map import serialization as JSER
from snakeslam_tpu.map.chaos import Chaos as JChaos
from snakeslam_tpu.map.slam_map import FrameData as JFrameData
from snakeslam_tpu.map.slam_map import SlamMap as JSlamMap
from snakeslam_tpu.viewer import export as JEX
from snakeslam_tpu_torch.core import trajectory as TTR
from snakeslam_tpu_torch.core.camera import Distortion, Pinhole
from snakeslam_tpu_torch.frontend.stereo_rectify import stereo_rectify
from snakeslam_tpu_torch.map import serialization as TSER
from snakeslam_tpu_torch.map.chaos import Chaos
from snakeslam_tpu_torch.map.slam_map import FrameData
from snakeslam_tpu_torch.utils import loop_problems as LP
from snakeslam_tpu_torch.viewer import export as TEX

FIELDS = TSER._KF_FIELDS + TSER._PT_FIELDS


@pytest.fixture(scope="module")
def maps():
    smap, _, _, _ = LP.build_map([LP.ring_pose(0.08 * i) for i in range(6)],
                                 n_points=30000, seed=5)
    return smap, LP.clone_map(smap, cls=JSlamMap)


def _assert_maps_equal(a, b, atol=0.0):
    assert TSER._KF_FIELDS == JSER._KF_FIELDS
    assert TSER._PT_FIELDS == JSER._PT_FIELDS
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype and va.shape == vb.shape, f
        if atol and va.dtype.kind == "f":
            np.testing.assert_allclose(va, vb, atol=atol, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(va, vb, err_msg=f)
    assert (a._next_kf, a._next_pt, a.state) == (b._next_kf, b._next_pt,
                                                 b.state)
    assert list(a._free_kfs) == list(b._free_kfs)
    assert list(a._free_pts) == list(b._free_pts)


def test_map_fields_exist_in_port(maps):
    tmap, _ = maps
    for f in FIELDS:
        assert isinstance(getattr(tmap, f), np.ndarray), f
    assert tmap.n_keyframes == 6 and tmap.n_points > 300


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(maps, tmp_path, writer):
    tmap, jmap = maps
    path = tmp_path / "map.npz"
    if writer == "jax":
        JSER.save_map(jmap, path)
        loaded = TSER.load_map(path)
    else:
        TSER.save_map(tmap, path)
        loaded = JSER.load_map(path)
    _assert_maps_equal(loaded, tmap)
    # the restored map supports further mutation
    ks = loaded.valid_keyframes()
    assert len(loaded.keyframe_points(int(ks[-1]))) > 0


def test_export_scene_and_ply_match_jax(maps, tmp_path):
    tmap, jmap = maps
    JSER.export_scene(jmap, tmp_path / "j.npz")
    TSER.export_scene(tmap, tmp_path / "t.npz")
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    js, ts = JEX.snapshot_map(jmap), TEX.snapshot_map(tmap)
    assert len(ts.covis_edges) == len(js.covis_edges) > 0
    JEX.write_ply(js, tmp_path / "j.ply")
    TEX.write_ply(ts, tmp_path / "t.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    snap = TEX.export_viewer_snapshot(tmap, tmp_path / "v", tag="m")
    assert (tmp_path / "v" / "m.ply").exists()
    assert len(snap.points) == tmap.n_points


def test_frame_overlay_png_matches_jax(tmp_path, rng):
    uv = rng.uniform(5, 60, size=(40, 2))
    img = rng.uniform(0, 255, size=(64, 80)).astype(np.float32)
    for cls, mod, name in ((JFrameData, JEX, "j"), (FrameData, TEX, "t")):
        f = cls(frame_id=3, timestamp=0.1, uv=uv,
                octave=np.zeros(40, np.int32), angle=np.zeros(40, np.float32),
                descriptors=np.zeros((40, 32), np.uint8),
                right=np.full(40, -1.0), depth=np.full(40, -1.0))
        f.matches = np.where(np.arange(40) % 3 == 0, 7, -1)
        for image, tag in ((img, "img"), (None, "canvas")):
            mod.write_frame_overlay(mod.snapshot_frame(f, image),
                                    tmp_path / f"{name}_{tag}.png",
                                    size=(80, 64))
    for tag in ("img", "canvas"):
        assert ((tmp_path / f"t_{tag}.png").read_bytes()
                == (tmp_path / f"j_{tag}.png").read_bytes())


def test_chaos_matches_jax(maps):
    tmap0, _ = maps
    tmap = LP.clone_map(tmap0)
    jmap = LP.clone_map(tmap0, cls=JSlamMap)
    tc, jc = Chaos(tmap, seed=1), JChaos(jmap, seed=1)
    for c in (tc, jc):
        c.remove_random_point(n=50)
        c.remove_random_observation(n=80)
        c.remove_random_keyframe()
        c.crazy_move(magnitude=0.5)
        c.remove_random_point(n=5)
    assert tmap.n_keyframes == 5 and tmap.n_points < tmap0.n_points
    _assert_maps_equal(tmap, jmap, atol=1e-12)
    moved = np.abs(tmap.pt_pos[tmap.valid_points()]
                   - tmap0.pt_pos[tmap.valid_points()]).max()
    assert moved > 0.05


@pytest.mark.parametrize("distorted", [False, True])
def test_stereo_rectify_matches_jax(rng, distorted):
    w = np.array([0.004, -0.009, 0.002])
    R_rl = np.asarray(jlie.so3_exp(jnp.asarray(w, dtype=jnp.float64)))
    t_rl = -R_rl @ np.array([0.11, 0.001, -0.002])
    jl = JPinhole.create(460.0, 458.0, 370.0, 240.0, dtype=jnp.float64)
    jr = JPinhole.create(457.0, 456.0, 372.0, 245.0, dtype=jnp.float64)
    tl = Pinhole.create(460.0, 458.0, 370.0, 240.0, dtype=torch.float64)
    tr = Pinhole.create(457.0, 456.0, 372.0, 245.0, dtype=torch.float64)
    jd = td = None
    if distorted:
        coeffs = (-0.28, 0.07, 0.0002, 0.00002)
        jd = JDistortion.create(*coeffs, dtype=jnp.float64)
        td = Distortion.create(*coeffs, dtype=torch.float64)
    jrl, jrr, jbf = j_rectify(jl, jr, R_rl, t_rl, jd, jd)
    trl, trr, tbf = stereo_rectify(tl, tr, R_rl, t_rl, td, td)
    assert abs(tbf - jbf) < 1e-9
    uv = rng.uniform([100, 80], [650, 400], size=(200, 2))
    for a, b in ((jrl, trl), (jrr, trr)):
        np.testing.assert_allclose(b.R_rect, a.R_rect, atol=1e-12)
        np.testing.assert_allclose(b.rectify_points(uv),
                                   a.rectify_points(uv), atol=1e-9)


def test_trajectory_io_matches_jax(tmp_path, rng):
    n = 50
    ts = np.sort(rng.uniform(0, 10, n))
    pos = rng.normal(size=(n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    JTR.write_tum(tmp_path / "j.tum", ts, pos, q)
    TTR.write_tum(tmp_path / "t.tum", ts, pos, q)
    assert (tmp_path / "t.tum").read_bytes() == (tmp_path / "j.tum").read_bytes()
    for a, b in zip(JTR.read_tum(tmp_path / "j.tum"),
                    TTR.read_tum(tmp_path / "j.tum")):
        np.testing.assert_array_equal(b, a)
    noisy = 1.3 * pos @ np.asarray(jlie.so3_exp(jnp.asarray(
        [0.1, -0.2, 0.3]))).T + [1.0, 2.0, 3.0]
    noisy = noisy + rng.normal(scale=0.01, size=noisy.shape)
    for ws in (True, False):
        for a, b in zip(JTR.umeyama(pos, noisy, with_scale=ws),
                        TTR.umeyama(pos, noisy, with_scale=ws)):
            np.testing.assert_allclose(b, a, atol=1e-12)
        ja, ta = (JTR.ate_rmse(pos, noisy, with_scale=ws),
                  TTR.ate_rmse(pos, noisy, with_scale=ws))
        np.testing.assert_allclose(ta, ja, atol=1e-12)
    tb = ts + rng.normal(scale=0.01, size=n)
    tb.sort()
    for a, b in zip(JTR.associate(ts, tb, max_dt=0.015),
                    TTR.associate(ts, tb, max_dt=0.015)):
        np.testing.assert_array_equal(b, a)
    assert np.isnan(TTR.ate_rmse(pos[:2], pos[:2])[0])
