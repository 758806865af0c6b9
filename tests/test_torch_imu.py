"""IMU functions: the port against the JAX package (float64 on both sides).

Tolerances: ``preintegrate`` / ``preintegrate_batch`` against the JAX scan
and against ``preintegrate_np`` within 1e-10 (bias Jacobians included);
``preint_with_bias_correction`` and ``predict`` within 1e-12;
``solve_gyro_bias`` against JAX and its numpy twin within 1e-10;
``solve_scale_gravity`` (plain, with accelerometer bias, with a lever arm,
on tests/test_imu.py's setups): s, g, ba within 1e-8;
``velocities_from_pairs`` within 1e-10; ``solve_imu_chain`` on a
12-keyframe chain padded to 16, each ``solve_*`` flag on and off and
``prior_bias_weight`` 0 and 10: v, bg, ba, g, s within 1e-7, cost within
1e-6 relative; its Jacobian (``torch.func.jacfwd``) against ``jax.jacfwd``
of the same residuals within 1e-9; the numpy twins identical to the JAX
package's; ``synth_imu`` within 1e-9 of the JAX package's copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snakeslam_tpu.ops import imu as JI
from snakeslam_tpu.utils import imu_synthetic as JSY
from snakeslam_tpu_torch.ops import imu as TI
from snakeslam_tpu_torch.utils import imu_synthetic as TSY
from snakeslam_tpu_torch.utils import vi_problems as VP

F64 = jnp.float64
G_WORLD = TSY.G_WORLD


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _tb(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.bool)


def _j(a):
    return jnp.asarray(np.asarray(a), dtype=F64)


def _window(data, t0, t1):
    sel = (data["t"] >= t0 - 1e-9) & (data["t"] < t1 - 1e-9)
    return data["omega"][sel], data["acc"][sel], data["dt"][sel]


def _assert_preint(a, b, atol):
    for name, x, y in zip(TI.Preint._fields, a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol,
                                   err_msg=name)


BG = np.array([0.004, -0.003, 0.002])
BA = np.array([0.03, 0.02, -0.04])


def test_synth_imu_matches_jax_copy():
    kw = dict(rate=200.0, bg=BG, ba=BA, gyro_noise=1e-4, acc_noise=1e-3)
    a = TSY.synth_imu(TSY.orbit_pose_wb, 0.0, 0.6, **kw)
    b = JSY.synth_imu(JSY.orbit_pose_wb, 0.0, 0.6, **kw)
    for k in ("t", "omega", "acc", "dt"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-9, err_msg=k)
    for t in (0.0, 0.7, 3.1):
        for x, y in zip(TSY.true_state(TSY.orbit_pose_wb, t),
                        JSY.true_state(JSY.orbit_pose_wb, t)):
            np.testing.assert_allclose(x, y, atol=1e-12)


def test_preintegrate_matches_jax_and_numpy_twin():
    data = TSY.synth_imu(TSY.orbit_pose_wb, 0.0, 0.5, rate=400.0)
    om, ac, dt = _window(data, 0.0, 0.5)
    # padded tail: masked samples must not move the delta
    S = len(om) + 7
    pad = lambda a: np.concatenate([a, np.ones((S - len(a),) + a.shape[1:])])
    mask = np.arange(S) < len(om)
    pt = TI.preintegrate(_t(pad(om)), _t(pad(ac)), _t(pad(dt)), _tb(mask),
                         _t(BG), _t(BA))
    pj = JI.preintegrate(_j(pad(om)), _j(pad(ac)), _j(pad(dt)),
                         jnp.asarray(mask), _j(BG), _j(BA))
    _assert_preint(pt, pj, 1e-10)
    _assert_preint(pt, TI.preintegrate_np(om, ac, dt, BG, BA), 1e-10)
    _assert_preint(TI.preintegrate_np(om, ac, dt, BG, BA),
                   JI.preintegrate_np(om, ac, dt, BG, BA), 1e-10)


def test_preintegrate_batch_over_keyframes():
    data = TSY.synth_imu(TSY.orbit_pose_wb, 0.0, 3.0, rate=200.0,
                         gyro_noise=1e-4, acc_noise=1e-3)
    S = 110
    om = np.zeros((6, S, 3)); ac = np.zeros((6, S, 3))
    dt = np.zeros((6, S)); mask = np.zeros((6, S), dtype=bool)
    wins = []
    for k in range(6):
        o, a, d = _window(data, 0.5 * k, 0.5 * k + 0.4 + 0.02 * k)
        n = len(o)
        om[k, :n], ac[k, :n], dt[k, :n], mask[k, :n] = o, a, d, True
        wins.append((o, a, d))
    pt = TI.preintegrate_batch(_t(om), _t(ac), _t(dt), _tb(mask), _t(BG),
                               _t(BA))
    pj = JI.preintegrate_batch(_j(om), _j(ac), _j(dt), jnp.asarray(mask),
                               _j(BG), _j(BA))
    _assert_preint(pt, pj, 1e-10)
    for k, (o, a, d) in enumerate(wins):
        _assert_preint([x[k] for x in pt],
                       TI.preintegrate_np(o, a, d, BG, BA), 1e-10)


def _preints(n_kf, kf_dt=0.5, bg=None, ba=None):
    data = TSY.synth_imu(TSY.orbit_pose_wb, 0.0, n_kf * kf_dt, rate=200.0,
                         bg=bg, ba=ba)
    states = [TSY.true_state(TSY.orbit_pose_wb, k * kf_dt)
              for k in range(n_kf)]
    pre = [TI.preintegrate_np(*_window(data, k * kf_dt, (k + 1) * kf_dt),
                              np.zeros(3), np.zeros(3))
           for k in range(n_kf - 1)]
    R = np.stack([s[0] for s in states])
    p = np.stack([s[1] for s in states])
    v = np.stack([s[2] for s in states])
    return R, p, v, pre


def _stack(pre, name):
    return np.stack([np.asarray(getattr(x, name)) for x in pre])


def test_bias_correction_and_predict():
    R, p, v, pre = _preints(3)
    pn = pre[0]
    pt = TI.Preint(*(_t(x) for x in pn))
    pj = JI.Preint(*(_j(x) for x in pn))
    for a, b in zip(TI.preint_with_bias_correction(pt, _t(BG), _t(BA)),
                    JI.preint_with_bias_correction(pj, _j(BG), _j(BA))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    out_t = TI.predict(pt, _t(R[0]), _t(v[0]), _t(p[0]), _t(G_WORLD))
    out_j = JI.predict(pj, _j(R[0]), _j(v[0]), _j(p[0]), _j(G_WORLD))
    out_n = TI.predict(pn, R[0], v[0], p[0], G_WORLD)   # numpy through it
    for a, b, c in zip(out_t, out_j, out_n):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
        np.testing.assert_allclose(c, np.asarray(b), atol=1e-12)
    # and it predicts the true state
    assert np.abs(out_n[2] - p[1]).max() < 5e-3


def test_solve_gyro_bias():
    R, p, v, pre = _preints(12, bg=np.array([0.02, -0.015, 0.01]))
    dR, J = _stack(pre, "dR"), _stack(pre, "J_R_bg")
    valid = np.ones(len(pre), dtype=bool)
    valid[3] = False
    dbg_t, rms_t = TI.solve_gyro_bias(_t(R[:-1]), _t(R[1:]), _t(dR), _t(J),
                                      _tb(valid))
    dbg_j, rms_j = JI.solve_gyro_bias(_j(R[:-1]), _j(R[1:]), _j(dR), _j(J),
                                      jnp.asarray(valid))
    dbg_n, rms_n = TI.solve_gyro_bias_np(R[:-1], R[1:], dR, J, valid)
    np.testing.assert_allclose(dbg_t.numpy(), np.asarray(dbg_j), atol=1e-10)
    np.testing.assert_allclose(dbg_n, np.asarray(dbg_j), atol=1e-10)
    assert abs(float(rms_t) - float(rms_j)) < 1e-10
    assert abs(float(rms_n) - float(rms_j)) < 1e-10
    dbg_jn, _ = JI.solve_gyro_bias_np(R[:-1], R[1:], dR, J, valid)
    np.testing.assert_array_equal(dbg_n, dbg_jn)


def _both_scale_gravity(R, p_vis, pre, **kw):
    dt = np.array([float(x.dt) for x in pre])
    dp, dv = _stack(pre, "dp"), _stack(pre, "dv")
    valid = np.ones(len(pre) - 1, dtype=bool)
    valid[-1] = False
    kw_t = {k: (_t(a) if isinstance(a, np.ndarray) else a)
            for k, a in kw.items()}
    kw_j = {k: (_j(a) if isinstance(a, np.ndarray) else a)
            for k, a in kw.items()}
    out_t = TI.solve_scale_gravity(
        _t(R), _t(p_vis), _t(dt[:-1]), _t(dt[1:]), _t(dp[:-1]), _t(dp[1:]),
        _t(dv[:-1]), _tb(valid), **kw_t)
    out_j = JI.solve_scale_gravity(
        _j(R), _j(p_vis), _j(dt[:-1]), _j(dt[1:]), _j(dp[:-1]), _j(dp[1:]),
        _j(dv[:-1]), jnp.asarray(valid), **kw_j)
    for a, b, name in zip(out_t, out_j, ("s", "g", "ba", "rms")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-8,
                                   err_msg=name)
    return out_t


def test_solve_scale_gravity_plain():
    R, p, v, pre = _preints(14)
    s, g, ba, _ = _both_scale_gravity(R, p / 2.7, pre)
    assert abs(float(s) - 2.7) / 2.7 < 0.02
    assert np.abs(g.numpy() - G_WORLD).max() < 0.15


def test_solve_scale_gravity_with_acc_bias():
    ba_true = np.array([0.05, -0.03, 0.08])
    R, p, v, pre = _preints(16, ba=ba_true)
    Jp, Jv = _stack(pre, "J_p_ba"), _stack(pre, "J_v_ba")
    s, g, ba, _ = _both_scale_gravity(
        R, p / 1.8, pre, Jp12_ba=Jp[:-1], Jp23_ba=Jp[1:], Jv12_ba=Jv[:-1],
        with_acc_bias=True)
    assert abs(float(s) - 1.8) / 1.8 < 0.05
    assert np.abs(ba.numpy() - ba_true).max() < 0.05


def test_solve_scale_gravity_with_lever_arm():
    R_cb = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t_cb = np.array([0.05, -0.02, 0.01])
    R_wb, p_wb, v, pre = _preints(14)
    R_cam = np.einsum("kij,lj->kil", R_wb, R_cb)
    p_cam = p_wb + np.einsum("kij,j->ki", R_wb, -R_cb.T @ t_cb)
    R_body = np.einsum("kij,jl->kil", R_cam, R_cb)
    s, g, _, _ = _both_scale_gravity(R_body, p_cam / 2.2, pre, R_cam=R_cam,
                                     t_cb=t_cb, with_lever=True)
    assert abs(float(s) - 2.2) / 2.2 < 0.01


def test_velocities_from_pairs():
    R, p, v, pre = _preints(10)
    dt = np.array([float(x.dt) for x in pre])
    dp, dv = _stack(pre, "dp"), _stack(pre, "dv")
    valid = np.ones(len(pre), dtype=bool)
    for use_dv in (False, True):
        vt = TI.velocities_from_pairs(
            _t(R), _t(p), _t(dt), _t(dp), _tb(valid),
            torch.tensor(1.0, dtype=torch.float64), _t(G_WORLD),
            dv=_t(dv) if use_dv else None)
        vj = JI.velocities_from_pairs(
            _j(R), _j(p), _j(dt), _j(dp), jnp.asarray(valid),
            jnp.float64(1.0), _j(G_WORLD), dv=_j(dv) if use_dv else None)
        vn = TI.velocities_from_pairs_np(R, p, dt, dp, 1.0, G_WORLD,
                                         dv=dv if use_dv else None)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
        np.testing.assert_allclose(vn, np.asarray(vj), atol=1e-10)
    assert np.abs(vt.numpy()[:-1] - v[:-1]).max() < 0.05


# ---------------------------------------------------------------------------
# decoupled chain solver
# ---------------------------------------------------------------------------

def _chains(n_kf=12, K=16, s_true=2.0):
    """A 12-keyframe chain with biased IMU, under-scaled positions, padded
    to K = 16 node slots, as both packages' ImuChain."""
    arrays = VP.chain_arrays(n_kf, K, s_true=s_true)
    v_true = arrays.pop("v_true")
    valid = arrays.pop("edge_valid")
    ch_t = TI.ImuChain(**{k: _t(a) for k, a in arrays.items()},
                       edge_valid=_tb(valid))
    ch_j = JI.ImuChain(**{k: _j(a) for k, a in arrays.items()},
                       edge_valid=jnp.asarray(valid))
    return ch_t, ch_j, n_kf, v_true


G0 = G_WORLD + np.array([0.3, -0.2, 0.1])


@pytest.mark.parametrize("flags", [
    dict(solve_scale=True),
    dict(solve_scale=False),
    dict(solve_scale=True, solve_bg=False),
    dict(solve_scale=True, solve_ba=False),
    dict(solve_scale=True, solve_gravity=False),
    dict(solve_scale=False, solve_velocity=False),
    dict(solve_scale=True, prior_bias_weight=10.0),
    dict(solve_scale=False, prior_bias_weight=10.0),
])
def test_solve_imu_chain(flags):
    ch_t, ch_j, n_kf, v_true = _chains()
    z = np.zeros(3)
    s0 = 1.2 if flags.get("solve_scale") else 2.0
    out_t = TI.solve_imu_chain(ch_t, _t(z), _t(z), _t(G0),
                               torch.tensor(s0, dtype=torch.float64),
                               iterations=4, **flags)
    out_j = JI.solve_imu_chain(ch_j, _j(z), _j(z), _j(G0), jnp.float64(s0),
                               iterations=4, **flags)
    for k in ("v", "bg", "ba", "g", "s"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-7, err_msg=k)
    cj = float(out_j["cost"])
    assert abs(float(out_t["cost"]) - cj) <= 1e-6 * max(cj, 1e-12)
    # padded velocity states stay where they started (zero)
    assert np.abs(out_t["v"].numpy()[n_kf:]).max() == 0.0
    if flags.get("solve_bg") is False:
        assert np.abs(out_t["bg"].numpy()).max() == 0.0
    if flags.get("solve_scale") and len(flags) == 1:
        assert abs(float(out_t["s"]) - 2.0) / 2.0 < 0.05


def test_chain_jacobian_matches_jax_jacfwd():
    """The GN's dense Jacobian: ``torch.func.jacfwd`` of the port's
    residuals against ``jax.jacfwd`` of the same residuals written with the
    JAX package's functions, at a perturbed state, within 1e-9."""
    from snakeslam_tpu.core import lie as JL

    ch_t, ch_j, n_kf, _ = _chains()
    K = 16
    rng = np.random.default_rng(4)
    x = np.concatenate([np.asarray(ch_j.v).reshape(-1),
                        rng.normal(scale=1e-2, size=9)])
    bg0, ba0 = np.array([0.002, 0.001, -0.001]), np.array([0.01, 0.0, 0.02])
    wR, wP, wV = 1000.0, 100.0, 10.0
    _, res_t = TI.chain_functions(ch_t, _t(bg0), _t(ba0), _t(G0),
                                  torch.tensor(1.3, dtype=torch.float64),
                                  wR, wP, wV, prior_bias_weight=10.0)

    def res_j(xv):   # snakeslam_tpu/ops/imu.py:355-427, outside its jit
        v = xv[: 3 * K].reshape(K, 3)
        dbg, dba = xv[3 * K: 3 * K + 3], xv[3 * K + 3: 3 * K + 6]
        theta = xv[3 * K + 6: 3 * K + 8]
        g0 = _j(G0)
        g_dir = g0 / jnp.linalg.norm(g0)
        b1 = jnp.cross(g_dir, jnp.asarray([1.0, 0.0, 0.0], F64))
        b1 = b1 / jnp.linalg.norm(b1)
        b2 = jnp.cross(g_dir, b1)
        g = jnp.float32(JI.GRAVITY).astype(F64) * (
            JL.so3_exp(theta[0] * b1 + theta[1] * b2) @ g_dir)
        s = 1.3 * jnp.exp(xv[3 * K + 8])
        c = ch_j
        dt = c.dt
        inv_dt = 1.0 / jnp.maximum(dt, 1e-4)
        R_i, R_j = c.R[:-1], c.R[1:]
        dR_c = c.dR @ JL.so3_exp(jnp.einsum("kij,j->ki", c.J_R_bg, dbg))
        dv_c = (c.dv + jnp.einsum("kij,j->ki", c.J_v_bg, dbg)
                + jnp.einsum("kij,j->ki", c.J_v_ba, dba))
        dp_c = (c.dp + jnp.einsum("kij,j->ki", c.J_p_bg, dbg)
                + jnp.einsum("kij,j->ki", c.J_p_ba, dba))
        r_R = JL.so3_log(jnp.swapaxes(dR_c, 1, 2)
                         @ jnp.swapaxes(R_i, 1, 2) @ R_j)
        r_v = jnp.einsum("kji,kj->ki", R_i,
                         v[1:] - v[:-1] - g[None] * dt[:, None]) - dv_c
        r_p = jnp.einsum(
            "kji,kj->ki", R_i,
            s * (c.p[1:] - c.p[:-1]) - v[:-1] * dt[:, None]
            - 0.5 * g[None] * (dt ** 2)[:, None]) - dp_c
        w = c.edge_valid.astype(F64)[:, None] * inv_dt[:, None]
        r = jnp.concatenate([r_R * np.sqrt(wR) * w, r_v * np.sqrt(wV) * w,
                             r_p * np.sqrt(wP) * w], axis=1).reshape(-1)
        return jnp.concatenate([r, np.sqrt(10.0)
                                * jnp.concatenate([dbg, dba])])

    np.testing.assert_allclose(res_t(_t(x)).numpy(),
                               np.asarray(res_j(_j(x))), atol=1e-10)
    Jt = torch.func.jacfwd(res_t)(_t(x)).numpy()
    Jj = np.asarray(jax.jit(jax.jacfwd(res_j))(_j(x)))
    assert Jt.shape == (9 * (K - 1) + 6, 3 * K + 9)
    np.testing.assert_allclose(Jt, Jj, atol=1e-9)


def test_numpy_twins_identical():
    rng = np.random.default_rng(2)
    w = rng.normal(scale=0.4, size=(20, 3))
    w[:3] *= 1e-10
    np.testing.assert_array_equal(TI.so3_exp_np(w), JI.so3_exp_np(w))
    R = TI.so3_exp_np(w)
    np.testing.assert_array_equal(TI.so3_log_np(R), JI.so3_log_np(R))
    np.testing.assert_allclose(TI.so3_log_np(R)[3:], w[3:], atol=1e-9)
    for n in (1, 16, 17, 33, 100):
        assert TI._pow2_bucket(n) == JI._pow2_bucket(n)
