"""Decoupled visual-inertial state estimation: the multi-stage initializer.

Counterpart of ``snakeslam_tpu/imu/state_solver.py``: host orchestration
mirroring the reference's ImuStateSolver state machine
(reference: Snake/IMU/ImuStateSolver.{h,cpp}):
  1. INITIALIZING_GYRO_BIAS — iterative global gyro-bias solve over keyframe
     rotation pairs with an rms gate of 0.008 rad (:170-348; map reset after
     15 failed iterations).
  2. INITIALIZING_GRAVITY_SCALE — linear scale/gravity(/acc-bias) solve over
     keyframe triplets, then rotate the whole map so gravity is canonical,
     rescale by init_scale, and compute per-keyframe velocities (:352-466).
  3. OPTIMIZING — staged refinements with the decoupled chain solver and
     growing accelerometer weight, interleaved with full BA (:86-143).

Raw IMU sample windows are kept per keyframe edge so preintegration can be
redone whenever the bias estimate changes (RecomputeWeights, :149-166);
preintegration is the host loop ``ops/imu.preintegrate_np``.  The two
solves that are not 3x3 work (``solve_scale_gravity``, ``solve_imu_chain``)
run as float64 tensors on the solver's device; their callers read the
results on the host at once.

Camera<-body extrinsics (Settings.T_cam_body) are applied throughout: the
rotation chains use body rotations R_wb = (R_cb^T R_cw)^T, and the position
lever arm (t_cb) is carried exactly through the linear scale/gravity solve
(the body position is affine in the visual scale, p_wb = s*p_wc + R_wc t_cb,
so the known lever contribution moves to the right-hand side — matching the
reference's body-frame solve, ImuStateSolver.cpp:352-466).  Velocity
propagation and the chain refinement evaluate body positions at the current
metric scale.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap
from snakeslam_tpu_torch.ops import imu as IMU
from snakeslam_tpu_torch.system.settings import Settings

GYRO_RMS_GATE = 0.008       # rad (ImuStateSolver.cpp threshold)
MIN_KF_FOR_GYRO = 8
MIN_KF_FOR_SCALE = 10
MAX_GYRO_FAILURES = 15
REFINE_SCHEDULE = (5.0, 15.0, 25.0, 50.0, 75.0)   # seconds after init
ACC_WEIGHT_SCHEDULE = (0.1, 0.3, 0.5, 0.8, 1.0)   # fraction of final weight


class VIStage(enum.Enum):
    GYRO_BIAS = 0
    GRAVITY_SCALE = 1
    OPTIMIZING = 2
    DONE = 3


@dataclass
class ImuEdge:
    """Raw samples + current preintegration between consecutive keyframes."""

    prev_kf: int
    omega: np.ndarray
    acc: np.ndarray
    dt: np.ndarray
    preint: object = None  # ops.imu.Preint at the current bias


class ImuStateSolver:
    def __init__(self, settings: Settings, smap: SlamMap, device, gba=None):
        self.s = settings
        self.map = smap
        self.device = torch.device(device)
        self.gba = gba
        self.stage = VIStage.GYRO_BIAS
        self.edges: dict[int, ImuEdge] = {}  # kf -> edge from its prev KF
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.gravity = np.array([0.0, 0.0, -IMU.GRAVITY])
        self.gravity_initialized = False
        self.gyro_initialized = False
        self.init_scale = 1.0
        self.gyro_iterations = 0
        self.init_done_time = -1.0
        self.refine_idx = 0
        self.pending_samples: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # runtime weights exposed to tracking/LBA (SnakeGlobal.h:183-185)
        self.current_gyro_weight = 0.0
        self.current_acc_weight = 0.0
        self.map_reset_requested = False
        # camera<-body extrinsics
        self.T_cb = np.asarray(settings.T_cam_body, dtype=np.float64
                               ).reshape(4, 4)
        self.R_cb = self.T_cb[:3, :3]
        # merge IMU sequences across culled keyframes (Keyframe.cpp:456-601)
        hook = getattr(smap, "on_erase_keyframe", None)
        if hook is not None and not any(
            getattr(cb, "__self__", None) is self for cb in hook
        ):
            hook.append(self._on_keyframe_erased)

    # ------------------------------------------------------------------

    def clear(self):
        self.__init__(self.s, self.map, self.device, self.gba)

    def _t(self, a) -> torch.Tensor:
        """A host array as a float64 (or bool) tensor on the solver's
        device."""
        a = np.asarray(a)
        if a.dtype != bool:
            a = a.astype(np.float64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def add_frame_samples(self, frame: FrameData):
        if frame.imu_omega is not None and len(frame.imu_omega):
            t = (frame.imu_t if frame.imu_t is not None
                 else np.full(len(frame.imu_omega), frame.timestamp))
            self.pending_samples.append(
                (frame.imu_omega, frame.imu_acc, frame.imu_dt, t)
            )

    # ------------------------------------------------------------------

    def process_new_keyframe(self, kf: int, prev_kf: int):
        """Bind pending samples to the edge prev_kf -> kf and preintegrate
        (reference: ProcessNewKeyframe, pre-LBA — ImuStateSolver.cpp:44-61)."""
        if prev_kf < 0 or not self.pending_samples:
            self.pending_samples = []
            return
        omega = np.concatenate([s[0] for s in self.pending_samples])
        acc = np.concatenate([s[1] for s in self.pending_samples])
        dt = np.concatenate([s[2] for s in self.pending_samples])
        ts = np.concatenate([s[3] for s in self.pending_samples])
        self.pending_samples = []
        # trim to the keyframe interval (pending may reach back before the
        # previous keyframe, e.g. across the mono-init bootstrap)
        t_prev = self.map.kf_timestamp[prev_kf]
        sel = ts >= t_prev - 1e-9
        omega, acc, dt = omega[sel], acc[sel], dt[sel]
        if len(omega) == 0:
            return
        edge = ImuEdge(prev_kf=prev_kf, omega=omega, acc=acc, dt=dt)
        self._preintegrate_edge(edge)
        self.edges[kf] = edge
        # propagate velocity estimate
        if self.gravity_initialized:
            Rwb_i = self._body_rotation(prev_kf)
            v_i = self.map.kf_velocity[prev_kf]
            p_i = self._body_positions([prev_kf])[0]
            # three 3-vector products: numpy arrays through the same
            # function (no device call per keyframe)
            Rj, vj, pj = IMU.predict(
                edge.preint, Rwb_i, np.asarray(v_i, np.float64), p_i,
                self.gravity)
            self.map.kf_velocity[kf] = vj
        self.map.kf_bias_gyro[kf] = self.bg
        self.map.kf_bias_acc[kf] = self.ba

    def _preintegrate_edge(self, edge: ImuEdge):
        edge.preint = IMU.preintegrate_np(
            edge.omega, edge.acc, edge.dt, self.bg, self.ba)

    def _on_keyframe_erased(self, kf: int):
        """Keyframe culled: splice its incoming IMU sequence into the edge
        of the NEXT keyframe in the chain, so simplification never destroys
        inertial information (reference Keyframe::SetBadFlag merges the
        culled KF's imu sequence into nextKF, Map/Keyframe.cpp:456-601)."""
        kf = int(kf)
        succ = next((k for k, e in self.edges.items()
                     if int(e.prev_kf) == kf and k != kf), None)
        if succ is None:
            # newest KF in the chain: nothing to splice into — drop its
            # incoming window explicitly (it ends at an erased keyframe)
            self.edges.pop(kf, None)
            return
        edge_in = self.edges.pop(kf, None)
        if edge_in is None:
            # chain head culled: the successor's edge now starts at an
            # erased keyframe with no predecessor to rewire to — drop it,
            # making the successor the new chain head
            self.edges.pop(succ, None)
            return
        e2 = self.edges[succ]
        merged = ImuEdge(
            prev_kf=int(edge_in.prev_kf),
            omega=np.concatenate([edge_in.omega, e2.omega]),
            acc=np.concatenate([edge_in.acc, e2.acc]),
            dt=np.concatenate([edge_in.dt, e2.dt]),
        )
        self._preintegrate_edge(merged)
        self.edges[succ] = merged

    def iterate_ba_imu(self, k: int = 10):
        """Final visual-inertial alternation (ImuStateSolver.cpp:469-484,
        invoked from System::run at System.cpp:190-200): k rounds of
        decoupled IMU chain solve + FullBA, one scale-solving pass, then k
        more rounds.  Each FullBA carries the IMU relative-pose factors
        when the GBA was constructed with this solver."""
        if self.gba is None or not self.gravity_initialized:
            return
        for _ in range(k):
            self._solve_chain(solve_scale=False)
            self.gba.full_ba(iterations=1)
        self._solve_chain(solve_scale=True)
        for _ in range(k):
            self._solve_chain(solve_scale=False)
            self.gba.full_ba(iterations=1)

    def recompute_weights(self):
        """Re-preintegrate every edge at the current bias
        (RecomputeWeights parity, ImuStateSolver.cpp:149-166)."""
        for edge in self.edges.values():
            self._preintegrate_edge(edge)

    # ------------------------------------------------------------------

    def _chain_keyframes(self):
        """Consecutive (kf, edge) pairs along the temporal chain, oldest
        first, for edges whose endpoints are still alive.  An edge is also
        dropped when its preintegration span no longer matches the keyframe
        timestamp gap (the endpoints were erased and their pool ids reused
        — keyframe pools recycle ids, Map.h:48-77 semantics)."""
        out = []
        stale = []
        for kf, edge in self.edges.items():
            if not (self.map.kf_valid[kf] and self.map.kf_valid[edge.prev_kf]):
                continue
            gap = (self.map.kf_timestamp[kf]
                   - self.map.kf_timestamp[edge.prev_kf])
            span = float(edge.preint.dt)
            if gap <= 0 or abs(gap - span) > 0.2 * max(gap, span):
                stale.append(kf)
                continue
            out.append((int(edge.prev_kf), int(kf), edge))
        for kf in stale:
            self.edges.pop(kf, None)
        out.sort(key=lambda e: self.map.kf_frame_id[e[1]])
        return out

    @staticmethod
    def _connected_suffix(chain):
        """Longest run of consecutive edges ending at the newest keyframe
        (edge k's end must be edge k+1's start).  The temporal chain can
        break when intermediate keyframes are culled; feeding a broken
        chain to the fixed-shape solver would pair poses with the wrong
        preintegrations."""
        if not chain:
            return chain
        start = 0
        for k in range(len(chain) - 1):
            if chain[k][1] != chain[k + 1][0]:
                start = k + 1
        return chain[start:]

    def _body_rotation(self, kf: int) -> np.ndarray:
        """R_wb of a keyframe: T_bw = T_cb^-1 T_cw -> R_wb = (R_cb^T R_cw)^T."""
        return (self.R_cb.T @ self.map.kf_pose[kf][:3, :3]).T

    def _body_rotations(self, chain):
        """R_wb at edge endpoints (camera<-body extrinsics applied)."""
        R_i = np.stack([self._body_rotation(i) for i, j, _ in chain])
        R_j = np.stack([self._body_rotation(j) for i, j, _ in chain])
        return R_i, R_j

    # ------------------------------------------------------------------

    def update_map(self):
        """The init state machine (UpdateMap, ImuStateSolver.cpp:73-146).
        Called after LBA for every keyframe."""
        if self.stage == VIStage.GYRO_BIAS:
            self._stage_gyro()
        elif self.stage == VIStage.GRAVITY_SCALE:
            self._stage_gravity_scale()
        elif self.stage == VIStage.OPTIMIZING:
            self._stage_refine()

    def _stage_gyro(self):
        chain = self._chain_keyframes()
        if len(chain) < MIN_KF_FOR_GYRO:
            return
        R_i, R_j = self._body_rotations(chain)
        valid = np.ones(len(chain), dtype=bool)
        dR0 = np.stack([np.asarray(e.preint.dR) for _, _, e in chain])
        Js = np.stack([np.asarray(e.preint.J_R_bg) for _, _, e in chain])
        dbg_total = np.zeros(3)
        rms = np.inf
        # the whole bias iteration runs HOST-SIDE (ops/imu host twins): the
        # arrays grow with the chain, the arithmetic is 3x3 normal
        # equations, and device calls would cost more in launches than the
        # arithmetic, 5x per keyframe here.  Inside the loop
        # the preintegrated rotations take the first-order bias correction
        # (their Jacobians exist for exactly this); one exact
        # re-preintegration lands after convergence.
        for it in range(5):
            dRs = dR0 @ IMU.so3_exp_np(
                np.einsum("kij,j->ki", Js, dbg_total))
            # outlier-edge rejection by rotational error (the reference
            # removes outlier KFs during gyro init, ImuStateSolver.cpp:240+)
            rel = np.swapaxes(dRs, 1, 2) @ np.swapaxes(R_i, 1, 2) @ R_j
            errs = np.linalg.norm(IMU.so3_log_np(rel), axis=1)
            med = np.median(errs[valid]) if valid.any() else 0.0
            valid = errs <= max(3.0 * med, 2.0 * GYRO_RMS_GATE) + 1e-12
            if valid.sum() < 4:
                valid[:] = True
            dbg, rms = IMU.solve_gyro_bias_np(R_i, R_j, dRs, Js, valid)
            dbg_total = dbg_total + dbg
        self.bg = self.bg + dbg_total
        self.recompute_weights()
        self.gyro_iterations += 1
        rms = float(rms)
        if rms < GYRO_RMS_GATE:
            self.gyro_initialized = True
            self.current_gyro_weight = self.s.weight_gyro_optimization
            self.stage = VIStage.GRAVITY_SCALE
        elif self.gyro_iterations > MAX_GYRO_FAILURES:
            # the map is inconsistent with the IMU: request a reset
            # (ImuStateSolver.cpp:277-280)
            self.map_reset_requested = True
            self.gyro_iterations = 0

    def _lever_args(self, ids):
        """Camera->world rotations + t_cb for the lever-arm-exact linear
        solve (ImuStateSolver.cpp:352-466 solves in body frame with full
        camera_to_body).  Identity rigs skip the extra term entirely."""
        t_cb = self.T_cb[:3, 3]
        identity = (np.abs(t_cb).max() < 1e-12)
        if identity:
            return dict(with_lever=False)
        R_cam = np.stack([self.map.kf_pose[k][:3, :3].T for k in ids])
        return dict(R_cam=R_cam, t_cb=self._t(t_cb), with_lever=True)

    def _body_positions(self, ids) -> np.ndarray:
        """Body origin in world per keyframe: p_wb = p_wc + R_wc t_cb
        (exact once the visual scale is metric)."""
        t_cb = self.T_cb[:3, 3]
        out = np.empty((len(ids), 3))
        for n, k in enumerate(ids):
            T = self.map.kf_pose[k]
            R_wc = T[:3, :3].T
            out[n] = -R_wc @ T[:3, 3] + R_wc @ t_cb
        return out

    def _linear_scale_gravity(self):
        """Linear scale/gravity estimate over keyframe triplets (the solve
        behind the init stage AND the refinement-stage metric correction).
        Returns (s, g) or None when the chain is too short or the estimate
        is non-finite.  NOTE: the joint scale/gravity/acc-bias solve is
        ill-conditioned on short chains with noisy visual poses (ba absorbs
        scale), so this uses the bias-free estimate — mirroring the
        reference's staging (scale/gravity first, ACC_BIAS afterwards,
        ImuStateSolver.h:43-53)."""
        chain = self._chain_keyframes()
        if len(chain) < MIN_KF_FOR_SCALE:
            return None
        # consecutive-edge triplets need edge j's end == edge j+1's start
        chain = self._connected_suffix(chain)
        if len(chain) < MIN_KF_FOR_SCALE:
            return None
        ids0 = [chain[0][0]] + [j for _, j, _ in chain]
        # body rotations (camera<-body extrinsics applied) + camera centers;
        # the lever-arm term carries t_cb exactly through the triplets
        R = np.stack([self._body_rotation(k) for k in ids0])
        p = np.stack(
            [-self.map.kf_pose[k][:3, :3].T @ self.map.kf_pose[k][:3, 3]
             for k in ids0]
        )
        pre = [e.preint for _, _, e in chain]
        dt = np.array([float(x.dt) for x in pre])
        dp = np.stack([np.asarray(x.dp) for x in pre])
        dv = np.stack([np.asarray(x.dv) for x in pre])
        # pad nodes/edges to a power-of-two bucket: the chain grows each
        # keyframe and this stage runs per keyframe until it converges;
        # buckets keep the shapes few
        K = len(ids0)
        Kp = IMU._pow2_bucket(K)
        Rp = np.tile(np.eye(3), (Kp, 1, 1)); Rp[:K] = R
        pp = np.zeros((Kp, 3)); pp[:K] = p
        E = len(pre)            # = K - 1 edges
        dtp = np.ones(Kp - 1); dtp[:E] = dt
        dpp = np.zeros((Kp - 1, 3)); dpp[:E] = dp
        dvp = np.zeros((Kp - 1, 3)); dvp[:E] = dv
        vtrip = np.zeros(Kp - 2, dtype=bool); vtrip[:E - 1] = True
        lever = self._lever_args(ids0)
        if lever.get("with_lever"):
            Rc = np.tile(np.eye(3), (Kp, 1, 1))
            Rc[:K] = lever["R_cam"]
            lever["R_cam"] = self._t(Rc)
        t = self._t
        s1, g1, _, _ = IMU.solve_scale_gravity(
            t(Rp), t(pp), t(dtp[:-1]), t(dtp[1:]), t(dpp[:-1]), t(dpp[1:]),
            t(dvp[:-1]), t(vtrip), **lever,
        )
        # one readback: the stage decides on the host right away
        x = torch.cat([s1[None], g1]).cpu().numpy()
        s_est = float(x[0])
        g_est = x[1:4]
        if s_est <= 1e-3 or not np.isfinite(g_est).all():
            return None
        return s_est, g_est

    def _stage_gravity_scale(self):
        est = self._linear_scale_gravity()
        if est is None:
            return
        s_est, g_est = est
        g_mag = np.linalg.norm(g_est)
        if abs(g_mag - IMU.GRAVITY) > 0.15 * IMU.GRAVITY:
            return  # not converged yet; wait for more keyframes
        self.init_scale = s_est
        self._apply_metric_correction(s_est, g_est)
        self.gravity_initialized = True
        self.current_acc_weight = (
            ACC_WEIGHT_SCHEDULE[0] * self.s.weight_acc_optimization
        )
        chain = self._chain_keyframes()
        if chain:
            self.init_done_time = self.map.kf_timestamp[chain[-1][1]]
        self.stage = VIStage.OPTIMIZING

    def _stage_refine(self):
        chain = self._chain_keyframes()
        if len(chain) < 3 or self.refine_idx >= len(REFINE_SCHEDULE):
            if self.refine_idx >= len(REFINE_SCHEDULE):
                self.stage = VIStage.DONE
            return
        newest_t = self.map.kf_timestamp[chain[-1][1]]
        if newest_t - self.init_done_time < REFINE_SCHEDULE[self.refine_idx]:
            return
        self.current_acc_weight = (
            ACC_WEIGHT_SCHEDULE[
                min(self.refine_idx, len(ACC_WEIGHT_SCHEDULE) - 1)
            ] * self.s.weight_acc_optimization
        )
        if self.gba is not None:
            # prune catastrophic observations, then refine POINTS against
            # the (fixed) poses.  A joint mono FullBA here redistributes
            # accumulated scale drift over the whole map (measured: camera
            # spread +17% in one 3-iteration pass, Sim3 ATE 0.008 -> 1.56)
            # and nothing inside this stage can reliably pull it back to
            # metric — the decoupled chain GN diverges on drifted chains
            # (s=0.04 estimates) and the linear triplet re-solve rejects.
            # The reference survives its staged FullBA because its
            # DecoupledImuSolver re-anchors scale immediately after
            # (ImuStateSolver.cpp:86-143); until the chain solver is that
            # robust, the staged refinement keeps poses fixed (point-only,
            # BAPointOnly parity) — LBA still refines poses locally with
            # gyro constraints every keyframe.
            self.gba.remove_outliers()
            self.gba.point_ba(iterations=4)
        self.refine_idx += 1

    def _apply_metric_correction(self, s_est: float, g_est: np.ndarray):
        """Rescale the map to metric + re-align gravity to canonical, then
        refresh preintegrations and closed-form velocities (the shared
        apply half of the gravity/scale init stage and any later metric
        re-anchor, ImuStateSolver.cpp:86-143)."""
        g_dir = g_est / np.linalg.norm(g_est)
        canonical = np.array([0.0, 0.0, -1.0])
        axis = np.cross(g_dir, canonical)
        sa = np.linalg.norm(axis)
        ca = float(np.dot(g_dir, canonical))
        if sa < 1e-9:
            R_align = np.eye(3) if ca > 0 else -np.eye(3)
        else:
            w = axis / sa * np.arctan2(sa, ca)
            R_align = IMU.so3_exp_np(w)
        self.map.transform(s_est, R_align, np.zeros(3))
        self.gravity = np.array([0.0, 0.0, -IMU.GRAVITY])
        self.recompute_weights()
        chain = self._chain_keyframes()
        if not chain:
            return
        ids = [chain[0][0]] + [j for _, j, _ in chain]
        R = np.stack([self._body_rotation(k) for k in ids])
        p = self._body_positions(ids)
        pre = [e.preint for _, _, e in chain]
        self.map.kf_velocity[ids] = IMU.velocities_from_pairs_np(
            R, p, np.array([float(x.dt) for x in pre]),
            np.stack([np.asarray(x.dp) for x in pre]),
            1.0, self.gravity,
            dv=np.stack([np.asarray(x.dv) for x in pre]),
        )

    # ------------------------------------------------------------------

    def _solve_chain(self, solve_scale: bool = False):
        chain = self._connected_suffix(self._chain_keyframes())
        if len(chain) < 3:
            return
        ids = [chain[0][0]] + [j for _, j, _ in chain]
        # body rotations + body positions: the chain residuals compare
        # against body-frame preintegrations.  (The solved scale still
        # multiplies the full body position; the lever part is metric and
        # scale-invariant, a ~|t_cb|*(s-1) approximation that vanishes as
        # s -> 1 in the refinement stages.)
        R = np.stack([self._body_rotation(k) for k in ids])
        p = self._body_positions(ids)
        pre = [e.preint for _, _, e in chain]
        # velocities are free variables: re-initialize them closed-form from
        # the current poses + preintegrations so insertion-time prediction
        # drift can never seed the GN into a bad basin
        v_init = IMU.velocities_from_pairs_np(
            R, p, np.array([float(x.dt) for x in pre]),
            np.stack([np.asarray(x.dp) for x in pre]),
            1.0, self.gravity,
            dv=np.stack([np.asarray(x.dv) for x in pre]),
        )
        self.map.kf_velocity[ids] = v_init
        # pad the chain to a power-of-two node bucket (edge_valid masks the
        # pad): the chain grows per keyframe and buckets keep the shapes
        # few.  Padded velocity states see only the 1e-6 damping row
        # (delta stays 0).
        K = len(ids)
        Kp = IMU._pow2_bucket(K)
        E = len(pre)

        def padN(a, fill):
            out = np.tile(fill, (Kp,) + (1,) * (np.ndim(fill)))
            out[:K] = a
            return out

        def padE(a, fill):
            out = np.tile(fill, (Kp - 1,) + (1,) * (np.ndim(fill)))
            out[:E] = a
            return out

        I3, Z3, z3 = np.eye(3), np.zeros((3, 3)), np.zeros(3)
        t = self._t

        def stackE(name, fill):
            return t(padE(np.stack([np.asarray(getattr(x, name))
                                    for x in pre]), fill))

        ch = IMU.ImuChain(
            R=t(padN(R, I3)),
            p=t(padN(p, z3)),
            v=t(padN(self.map.kf_velocity[ids], z3)),
            dt=t(padE(np.array([float(x.dt) for x in pre]),
                      np.float64(1.0))),
            dR=stackE("dR", I3), dv=stackE("dv", z3), dp=stackE("dp", z3),
            J_R_bg=stackE("J_R_bg", Z3), J_v_bg=stackE("J_v_bg", Z3),
            J_v_ba=stackE("J_v_ba", Z3), J_p_bg=stackE("J_p_bg", Z3),
            J_p_ba=stackE("J_p_ba", Z3),
            edge_valid=t(np.arange(Kp - 1) < E),
        )
        out = IMU.solve_imu_chain(
            ch, t(self.bg), t(self.ba), t(self.gravity),
            torch.ones((), dtype=torch.float64, device=self.device),
            solve_scale=solve_scale, iterations=4,
            prior_bias_weight=10.0,
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}
        s = float(out["s"])
        new_bg = np.asarray(out["bg"], dtype=np.float64)
        new_ba = np.asarray(out["ba"], dtype=np.float64)
        if (not np.isfinite(s)
                or abs(np.log(max(s, 1e-9))) > np.log(1.5)
                or not np.isfinite(new_bg).all()
                or not np.isfinite(new_ba).all()
                or np.linalg.norm(new_bg) > 0.3
                or np.linalg.norm(new_ba) > 2.0):
            return  # refinement diverged; keep the current state
        self.bg = new_bg
        self.ba = new_ba
        self.map.kf_velocity[ids] = np.asarray(out["v"])[:len(ids)]
        g_new = np.asarray(out["g"], dtype=np.float64)
        # re-canonicalize gravity + scale onto the map
        if solve_scale and abs(s - 1.0) > 1e-4:
            g_dir = g_new / np.linalg.norm(g_new)
            canonical = np.array([0.0, 0.0, -1.0])
            axis = np.cross(g_dir, canonical)
            sa = np.linalg.norm(axis)
            ca = float(np.dot(g_dir, canonical))
            if sa < 1e-9:
                R_align = np.eye(3)
            else:
                w = axis / sa * np.arctan2(sa, ca)
                R_align = IMU.so3_exp_np(w)
            self.map.transform(s, R_align, np.zeros(3))
            self.map.kf_velocity[ids] = (
                np.asarray(out["v"])[:len(ids)] @ R_align.T
            )
        self.recompute_weights()

    # ------------------------------------------------------------------
    # LBA relative-pose (gyro) constraints
    # ------------------------------------------------------------------

    def rpc_for_window(self, window: list[int]):
        """Relative rotation constraints between consecutive window KFs
        (the reference builds these in MakeLocalScene,
        LocalBundleAdjustment.cpp:295-347, weight current_gyro_weight/dt)."""
        if not self.gyro_initialized or self.current_gyro_weight <= 0:
            return None
        in_window = set(window)
        rpc = []
        for kf, edge in self.edges.items():
            if kf in in_window and edge.prev_kf in in_window:
                dR = np.asarray(edge.preint.dR)
                # camera-frame relative pose from the preintegrated rotation:
                # T_j T_i^-1 has rotation R_cw_j R_wc_i = (R_wb_j)^T R_wb_i
                # = (R_wb_i dR)^T R_wb_i ... = dR^T in body; body == camera
                T = np.eye(4)
                T[:3, :3] = dR.T
                w_rot = self.current_gyro_weight / max(float(edge.preint.dt),
                                                       1e-3)
                rpc.append((edge.prev_kf, kf, T, 0.0, w_rot))
        return rpc or None
