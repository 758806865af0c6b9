"""The multi-device path: the port's mesh, sharded matcher and sharded BA
step against the JAX package's on the 8 virtual CPU devices of
tests/conftest.py.

Counterpart of tests/test_multichip.py.  The JAX package shards with
``jax.shard_map``; the port drives a list of devices from one process
(``parallel/multichip.py``), here 8 shards all on the CPU.

Tolerances: the sharded matcher's distances and indices exact; the
sharded BA step (tests/test_ba.py's noise-free problem, C = 8, P = 256,
M = 8, 8 shards, 5 iterations, lam 1e-6) in float32 within 1e-4 (cameras)
and 1e-3 (points) of the JAX step, in float64 within 1e-8, with the IMU
relative-pose factors on within 1e-8; a mesh of 1 within 1e-9 of a mesh
of 8 (float64; only the order of the reduce differs); reruns
bit-identical.  ``GlobalBA(n_devices=8).full_ba(2)`` on the dry run's map
(the port in float64, the JAX package in float32) within 1e-4 m of the
JAX package's, cost NaN in both.  The full ``SlamSystem`` with 8 shards
against 1 (test_multichip.py's scenario): the same frames tracked, ATE
below 0.05 m, the two ATEs within 5e-3 m.  The dataset CLI with
``n_devices = 4`` in its INI runs finalize's full BAs sharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snakeslam_tpu.core import lie as JL
from snakeslam_tpu.core.camera import Pinhole as JPinhole
from snakeslam_tpu.ops.ba import BAProblem as JProblem
from snakeslam_tpu.parallel import multichip as JMC
from snakeslam_tpu_torch.core.camera import Pinhole as TPinhole
from snakeslam_tpu_torch.parallel import multichip as TMC
from snakeslam_tpu_torch.utils.convert import ba_problem_from_numpy
from test_ba import _cam_errs, _make_ba_problem

FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
BF = 458.654 * 0.11


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the test workers share the machine's cores,
    and oversubscribed thread pools spin on the runs' small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _numpy(problem):
    return JProblem(*(np.asarray(v) for v in problem))


def _jax_problem(problem, dtype):
    return JProblem(*(jnp.asarray(v, dtype=dtype) if v.dtype.kind == "f"
                      else jnp.asarray(v) for v in problem))


def _with_rpc(problem, cams_true):
    """Relative-pose constraints between consecutive cameras: the true
    relative poses perturbed by ~1 mm and ~1 mrad (seeded), weight 100 on
    every axis."""
    C = len(cams_true)
    R = C - 1
    rng = np.random.default_rng(5)
    noise = [np.asarray(JL.se3_exp(jnp.asarray(rng.normal(size=6) * 1e-3)))
             for _ in range(R)]
    return problem._replace(
        rpc_i=np.arange(R, dtype=np.int32),
        rpc_j=np.arange(1, R + 1, dtype=np.int32),
        rpc_T=np.stack([noise[i] @ cams_true[i + 1]
                        @ np.linalg.inv(cams_true[i]) for i in range(R)]),
        rpc_weight=np.full((R, 6), 100.0),
        rpc_valid=np.ones(R, dtype=bool))


def _jax_step(problem, dtype, n_iters=5, lam=1e-6):
    cam = JPinhole.create(FX, FY, CX, CY, dtype=dtype)
    mesh = JMC.make_mesh()
    step = JMC.sharded_ba_step(mesh, cam, jnp.asarray(BF, dtype=dtype),
                               n_iters=n_iters, lam=lam)
    cam_pose, points = step(JMC.shard_problem(_jax_problem(problem, dtype),
                                              mesh))
    return np.asarray(cam_pose), np.asarray(points)


def _port_step(problem, dtype, n_shards=8, n_iters=5, lam=1e-6):
    cam = TPinhole.create(FX, FY, CX, CY, dtype=dtype)
    mesh = TMC.make_mesh(n_shards, "cpu")
    step = TMC.sharded_ba_step(mesh, cam, torch.tensor(BF, dtype=dtype),
                               n_iters=n_iters, lam=lam)
    cam_pose, points = step(TMC.shard_problem(
        ba_problem_from_numpy(problem, "cpu", dtype), mesh))
    return cam_pose.numpy(), points.numpy()


@pytest.fixture(scope="module")
def ba_problem():
    problem, cams_true, pts_true, _ = _make_ba_problem(
        np.random.default_rng(0), C=8, P=256, M=8, noise_px=0.0)
    return _numpy(problem), cams_true, pts_true


def test_mesh_of_8_cpu_shards():
    assert len(jax.devices()) == 8
    mesh = TMC.make_mesh(8, "cpu")
    assert mesh.size == 8 and not mesh.distinct
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        TMC.make_mesh(0, "cpu")


def test_sharded_hamming_matches_jax():
    rng = np.random.default_rng(0)
    pbits = rng.integers(0, 2, size=(1024, 256)).astype(np.int8)
    fbits = rng.integers(0, 2, size=(512, 256)).astype(np.int8)
    jd, ji = JMC.sharded_hamming_topk(JMC.make_mesh())(jnp.asarray(pbits),
                                                       jnp.asarray(fbits))
    td, ti = TMC.sharded_hamming_topk(TMC.make_mesh(8, "cpu"))(
        torch.from_numpy(pbits), torch.from_numpy(fbits))
    assert td.dtype == ti.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    H = (pbits[:, None, :] != fbits[None, :, :]).sum(axis=2)
    np.testing.assert_array_equal(td.numpy(), H.min(axis=1))
    np.testing.assert_array_equal(ti.numpy(), H.argmin(axis=1))


def test_sharded_ba_step_f32_matches_jax_and_converges(ba_problem):
    problem, cams_true, pts_true = ba_problem
    jc, jp = _jax_step(problem, jnp.float32)
    tc, tp = _port_step(problem, torch.float32)
    assert np.abs(tc - jc).max() < 1e-4
    assert np.abs(tp - jp).max() < 1e-3
    for c, p in ((jc, jp), (tc, tp)):
        assert _cam_errs(c, cams_true).max() < 1e-3
        assert np.abs(p - pts_true).max() < 1e-2


@pytest.mark.parametrize("rpc", [False, True], ids=["visual", "with_rpc"])
def test_sharded_ba_step_f64_matches_jax(ba_problem, rpc):
    problem, cams_true, _ = ba_problem
    if rpc:
        problem = _with_rpc(problem, cams_true)
    jc, jp = _jax_step(problem, jnp.float64)
    tc, tp = _port_step(problem, torch.float64)
    assert tc.dtype == tp.dtype == np.float64
    assert np.abs(tc - jc).max() < 1e-8
    assert np.abs(tp - jp).max() < 1e-8
    # the factors moved the solution (they are not ignored)
    if rpc:
        vc, _ = _port_step(ba_problem[0], torch.float64)
        assert np.abs(vc - tc).max() > 1e-5


def test_mesh_of_1_agrees_with_8_and_reruns_are_bit_identical(ba_problem):
    problem, cams_true, _ = ba_problem
    problem = _with_rpc(problem, cams_true)
    c8, p8 = _port_step(problem, torch.float64)
    c1, p1 = _port_step(problem, torch.float64, n_shards=1)
    assert np.abs(c8 - c1).max() < 1e-9
    assert np.abs(p8 - p1).max() < 1e-9 * np.abs(p1).max()
    c8b, p8b = _port_step(problem, torch.float64)
    np.testing.assert_array_equal(c8, c8b)
    np.testing.assert_array_equal(p8, p8b)


def test_shard_problem_raises_on_uneven_points():
    problem, _, _, _ = _make_ba_problem(np.random.default_rng(0), C=4, P=60,
                                        M=4)
    mesh = TMC.make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="equal shards"):
        TMC.shard_problem(ba_problem_from_numpy(_numpy(problem), "cpu"),
                          mesh)
    shards = TMC.shard_problem(
        ba_problem_from_numpy(_numpy(problem), "cpu"), TMC.make_mesh(4, "cpu"))
    assert [s.points.shape[0] for s in shards] == [15] * 4
    assert all(s.cam_pose.shape == (4, 4, 4) for s in shards)


def test_global_ba_sharded_matches_jax(tmp_path):
    from snakeslam_tpu.map.serialization import load_map as jax_load_map
    from snakeslam_tpu.optim.gba import GlobalBA as JGlobalBA
    from snakeslam_tpu.system.settings import InputType as JInputType
    from snakeslam_tpu.system.settings import Settings as JSettings
    from snakeslam_tpu_torch.map.serialization import save_map
    from snakeslam_tpu_torch.optim.gba import GlobalBA

    s, tmap, ids = TMC.dryrun_map(8)
    save_map(tmap, tmp_path / "map.npz")
    jmap = jax_load_map(tmp_path / "map.npz")
    js = JSettings()
    js.input_type = JInputType.Stereo
    js.enable_imu = False
    js.n_devices = 8
    jgba = JGlobalBA(js, jmap)
    assert jgba._mesh is not None and jgba._mesh.size == 8
    tgba = GlobalBA(s, tmap, "cpu")
    assert tgba._mesh.size == 8 and not tgba._mesh.distinct
    before = tmap.pt_pos[ids].copy()
    assert np.isnan(jgba.full_ba(iterations=2))
    assert np.isnan(tgba.full_ba(iterations=2))
    kfs = tmap.valid_keyframes()
    np.testing.assert_array_equal(kfs, jmap.valid_keyframes())
    assert np.abs(tmap.pt_pos[ids] - before).max() > 1e-3
    assert np.abs(tmap.pt_pos[ids] - jmap.pt_pos[ids]).max() < 1e-4
    assert np.abs(tmap.kf_pose[kfs] - jmap.kf_pose[kfs]).max() < 1e-4


def test_slam_system_sharded_full_ba():
    """The full SlamSystem with 8 shards: every finalize full BA runs
    sharded, and the trajectory matches the single-device run."""
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu_torch.optim import gba as GBA
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                     orbit_trajectory)

    sharded_calls = []
    inner = GBA.GlobalBA._sharded_full_ba

    def counted(self, problem, iterations):
        sharded_calls.append(iterations)
        return inner(self, problem, iterations)

    def run(n_devices):
        settings = Settings()
        settings.input_type = InputType.Stereo
        settings.enable_imu = False
        settings.n_devices = n_devices
        settings.feature_slots = 1024
        settings.local_map_slots = 2048
        settings.lba_cam_slots = 24
        settings.lba_point_slots = 4096
        settings.lba_obs_slots = 8
        settings.th_depth = 25.0
        world = SyntheticWorld(n_points=2000, seed=3)
        apply_world_to_settings(world, settings)
        system = SlamSystem(settings, "cpu")
        frames = list(synthetic_frames(
            world, orbit_trajectory(30, radius=7.0, arc=0.8),
            settings, noise_px=0.3))
        for f in frames:
            system.process_frame(f)
        system.finalize(gba_iterations=3)
        rmse, _, n = system.ate_against_gt(with_scale=False)
        return system, rmse, n

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GBA.GlobalBA, "_sharded_full_ba", counted)
        sys8, rmse8, n8 = run(8)
        assert sys8.map.n_keyframes >= 2
        assert sharded_calls == [3, 3, 3], sharded_calls
        sys1, rmse1, n1 = run(1)
        assert len(sharded_calls) == 3   # the single-device run: unsharded
    assert rmse8 < 0.05, f"sharded-finalize ATE {rmse8}"
    assert n8 == n1 == 30
    assert abs(rmse8 - rmse1) < 5e-3, (rmse8, rmse1)


def test_cli_with_n_devices_in_the_ini_runs_sharded(tmp_path):
    """``python -m snakeslam_tpu_torch`` with ``n_devices = 4`` in the
    INI's Capacity section: finalize's three full BAs run sharded (8
    frames of the rendered TUM lane at tests/test_torch_cli.py's size)."""
    import configparser
    import contextlib
    import io

    from snakeslam_tpu_torch.__main__ import main
    from snakeslam_tpu_torch.optim import gba as GBA
    from snakeslam_tpu_torch.utils import tum_fixture as TF
    from test_torch_cli import SMALL

    TF.write_tum_fixture(tmp_path / "tum", TF.lane_world(scale=0.5),
                         TF.lane_trajectory(32)[::4])
    ini = TF.copy_config(tmp_path / "mc.ini", **SMALL)
    cp = configparser.ConfigParser()
    cp.read(ini)
    cp.set("Capacity", "n_devices", "4")
    with open(ini, "w") as f:
        cp.write(f)
    calls = []
    inner = GBA.GlobalBA._sharded_full_ba

    def counted(self, problem, iterations):
        calls.append(self._mesh.size)
        return inner(self, problem, iterations)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(GBA.GlobalBA, "_sharded_full_ba", counted)
        rc = main([str(ini), "--dataset", str(tmp_path / "tum"),
                   "--outDir", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0
    assert "tracked 8 frames" in buf.getvalue()
    assert calls == [4, 4, 4], calls


def test_dryrun_multichip_on_cpu():
    from snakeslam_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, "cpu")


def test_entry_matches_graft_entry():
    import __graft_entry__ as G
    from snakeslam_tpu_torch.entry import entry
    from snakeslam_tpu_torch.models import tracking_step as TS
    from snakeslam_tpu.models import tracking_step as JTS

    jfn, jargs = G.entry()
    tfn, targs = entry("cpu")
    jT, jn = jfn(*jargs)
    tT, tn = tfn(*targs)
    assert int(tn) == int(jn)
    assert np.abs(tT.numpy() - np.asarray(jT)).max() < 2e-4
    jout = JTS.fine_step(*jargs)
    tout = TS.fine_step(*targs)
    for k in ("visible", "found", "matched", "fine_assign"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    assert int(tout["visible"].sum()) > 0
