"""Robust reprojection optima in plain PyTorch, the judge of the tracker's
poses and of the final map.

The cost is the one a stereo / RGB-D SLAM back-end minimizes (ORB-SLAM2's
pose optimizer and bundle adjustment, the upstream project's too): per
observation the pixel residual (u, v) of the projected point, and for a
feature with a right-image coordinate (a stereo match, or RGB-D's virtual
right ``u - bf / depth``) the right residual ``u - bf / z - u_r``; each
squared residual weighted by the octave's inverse scale squared, under a
Huber kernel of width 2.1 (two rows) or 2.3 (three rows) on the weighted
error.  The solvers iterate Gauss-Newton with Huber reweighting to a fixed
point: at it the program's own iterates, if they converged, sit too.

A pose problem may also hold rotation terms, the IMU's terms in the
problems the program solves with an IMU on (the tracker's gyro rotation
prior, the global BA's relative-rotation constraints between keyframes):
each the residual ``log(A R B)`` of the judged pose's rotation ``R`` in
SO(3)'s tangent, with weight ``w``, costing ``w |r|^2`` with no robust
kernel, as the program's pose solve and BA weigh them (the rotation rows
of their SE(3) residuals; the program sets those terms no translation
weight).  The reference linearizes them exactly: ``d r / d w =
Jl(r)^-1 A`` under ``R <- exp(w) R``.

Every function takes the float dtype it computes in, so the same code is
the float64 reference and its lower-precision control (``bfloat16``; the
6x6 and 3x3 solves go through float32, which torch offers for them).
"""

from __future__ import annotations

import torch

HUBER_MONO = 2.1
HUBER_STEREO = 2.3


def inv_scale_sq(octave: torch.Tensor, scale_factor: float,
                 dtype) -> torch.Tensor:
    """The weight of an observation at ``octave``: 1 / scale_factor^(2 o)."""
    return torch.pow(torch.tensor(scale_factor, dtype=torch.float64,
                                  device=octave.device),
                     -2.0 * octave.to(torch.float64)).to(dtype)


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(d: torch.Tensor):
    """(..., 6) twist (translation, rotation) -> R (..., 3, 3), t (..., 3)."""
    v, w = d[..., :3], d[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / ths**2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (ths - torch.sin(ths)) / ths**3)
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=d.dtype, device=d.device).expand_as(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, (V @ v[..., None])[..., 0]


def _project(Xc, cam, bf):
    """Predicted (u, v, u_right) of camera-frame points and their Jacobian
    with respect to the point, (..., 3, 3)."""
    fx, fy, cx, cy = cam
    X, Y, Z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(Z.abs() > 1e-9, Z, torch.full_like(Z, 1e-9))
    u = fx * X * iz + cx
    v = fy * Y * iz + cy
    ur = u - bf * iz
    z0 = torch.zeros_like(X)
    iz2 = iz * iz
    du = torch.stack([fx * iz, z0, -fx * X * iz2], -1)
    dv = torch.stack([z0, fy * iz, -fy * Y * iz2], -1)
    dr = torch.stack([fx * iz, z0, (bf - fx * X) * iz2], -1)
    return torch.stack([u, v, ur], -1), torch.stack([du, dv, dr], -2)


def _robust_weights(r, stereo, w2, valid):
    """Per observation: the Huber-reweighted weight of its squared residual
    and its weighted chi2."""
    chi2 = w2 * (r * r).sum(-1)
    delta = torch.where(stereo, torch.full_like(chi2, HUBER_STEREO),
                        torch.full_like(chi2, HUBER_MONO))
    e = torch.sqrt(chi2)
    hub = torch.where(e > delta, delta / torch.where(e > 0, e, 1.0),
                      torch.ones_like(e))
    return torch.where(valid, w2 * hub, torch.zeros_like(w2)), chi2


def _huber_cost(r, stereo, w2, valid):
    """Per problem: the sum of the Huber-robustified weighted chi2 over
    its observations (the last dimension before the residual rows)."""
    chi2 = w2 * (r * r).sum(-1)
    delta = torch.where(stereo, torch.full_like(chi2, HUBER_STEREO),
                        torch.full_like(chi2, HUBER_MONO))
    e = torch.sqrt(chi2)
    rho = torch.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)
    return torch.where(valid, rho, torch.zeros_like(rho)).sum(-1)


def _solve(H, g):
    """Gauss-Newton steps of a batch of normal equations.  A problem whose
    matrix is singular (no observation left, or a point seen along one
    ray, or rounding in a lower precision) takes no step: along its null
    directions the cost does not change."""
    dt = H.dtype
    if dt not in (torch.float32, torch.float64):
        H, g = H.float(), g.float()
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    empty = H.diagonal(dim1=-2, dim2=-1).sum(-1) <= 0
    H = torch.where(empty[..., None, None], eye, H)
    d, info = torch.linalg.solve_ex(H, g[..., None])
    d = d[..., 0]
    bad = empty | (info != 0) | ~torch.isfinite(d).all(-1)
    return torch.where(bad[..., None], torch.zeros_like(d), d).to(dt)


def _line_search(cost0, cost_at, d, halvings: int = 20):
    """Per problem the largest step of 1, 1/2, 1/4, ... that does not
    raise the Huber cost (0 where none does): the reweighted Gauss-Newton
    step then descends to the cost's minimum instead of cycling between
    kernel regions."""
    step = torch.ones_like(cost0)
    done = torch.zeros_like(cost0, dtype=torch.bool)
    for _ in range(halvings):
        ok = cost_at(step) <= cost0
        done = done | ok
        if bool(done.all()):
            break
        step = torch.where(done, step, step * 0.5)
    return torch.where(done, step, torch.zeros_like(step))


def _converged(d, x) -> bool:
    """Steps at the rounding of the iterate: a float64 solve stops there;
    a lower precision, whose steps do not fall below its rounding, runs
    its full count."""
    if d.dtype != torch.float64:
        return False
    return bool((d.abs().amax(-1) <= 1e-13 * (1.0 + x.abs().amax(-1))).all())


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (..., 3) of rotations R (..., 3, 3), through the
    unit quaternion built from its largest component (Shepperd 1978)."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    a21, a02, a10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    big = torch.stack([1.0 + tr, 1.0 + 2.0 * d0 - tr, 1.0 + 2.0 * d1 - tr,
                       1.0 + 2.0 * d2 - tr], -1)
    k = big.argmax(-1, keepdim=True)
    s = 2.0 * torch.sqrt(torch.clamp(big.gather(-1, k)[..., 0], min=1e-30))
    q = torch.stack([
        torch.stack([s / 4, a21 / s, a02 / s, a10 / s], -1),
        torch.stack([a21 / s, s / 4, s01 / s, s02 / s], -1),
        torch.stack([a02 / s, s01 / s, s / 4, s12 / s], -1),
        torch.stack([a10 / s, s02 / s, s12 / s, s / 4], -1)], -2)
    q = q.gather(-2, k[..., None].expand(*k.shape[:-1], 1, 4))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    w, v = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(v, dim=-1)
    f = torch.where(n > 0, 2.0 * torch.atan2(n, w)
                    / torch.where(n > 0, n, torch.ones_like(n)), 2.0 / w)
    return f[..., None] * v


def _jl_inv(r: torch.Tensor) -> torch.Tensor:
    """SO(3)'s inverse left Jacobian (..., 3, 3) at rotation vectors r:
    I - [r]x / 2 + c [r]x^2, c = 1 / th^2 - cot(th / 2) / (2 th), by its
    series under 0.1 rad (where the closed form cancels)."""
    th2 = (r * r).sum(-1)
    th = torch.sqrt(th2)
    small = th < 0.1
    ths = torch.where(small, torch.ones_like(th), th)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
                    1.0 / ths**2 - 1.0 / (2.0 * ths * torch.tan(ths / 2.0)))
    W = _hat(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand_as(W)
    return eye - 0.5 * W + c[..., None, None] * (W @ W)


def rotation_terms(R, A, B):
    """Residuals r = log(A R B) (n, K, 3) of K rotation terms of each of
    the rotations R (n, 3, 3), with A and B (n, K, 3, 3), and their
    Jacobians (n, K, 3, 3) under R <- exp(w) R: log(exp(A w) A R B) =
    r + Jl(r)^-1 A w to first order."""
    r = so3_log(A @ R[:, None] @ B)
    return r, _jl_inv(r) @ A


def rotation_cost(R, A, B, w) -> torch.Tensor:
    """Per rotation: sum(w |r|^2) over its rotation terms (``w`` (n,
    K))."""
    r = so3_log(A @ R[:, None] @ B)
    return (w * (r * r).sum(-1)).sum(-1)


def solve_poses(T0, points, uv, right, w2, valid, cam, bf, dtype,
                iterations: int = 50, rotation=None):
    """Pose-only optima of B problems: T0 (B, 4, 4) starting poses
    (world -> camera), points (B, N, 3) world points, uv (B, N, 2),
    right (B, N) (<= 0: no right coordinate), w2 (B, N) octave weights,
    valid (B, N); ``rotation``, where given, (A, B, w) of K rotation
    terms a problem, A and B (B, K, 3, 3), w (B, K) (0: no term).
    Returns (B, 4, 4) in ``dtype``."""
    dev = T0.device
    cast = [t.to(dev, dtype) for t in (T0, points, uv, right, w2)]
    T0, points, uv, right, w2 = cast
    valid = valid.to(dev)
    cam = tuple(torch.tensor(c, dtype=dtype, device=dev) for c in cam)
    bf = torch.tensor(bf, dtype=dtype, device=dev)
    stereo = right > 0
    rows = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo),
                        stereo], -1).to(dtype)
    obs = torch.cat([uv, right[..., None]], -1)
    R, t = T0[:, :3, :3], T0[:, :3, 3]
    if rotation is not None:
        rotation = tuple(x.to(dev, dtype) for x in rotation)

    def residuals(R, t):
        Xc = (R[:, None] @ points[..., None])[..., 0] + t[:, None]
        pred, dP = _project(Xc, cam, bf)
        return (pred - obs) * rows, dP, Xc

    def cost(r, R):
        c = _huber_cost(r, stereo, w2, valid)
        if rotation is not None:
            c = c + rotation_cost(R, *rotation)
        return c

    for _ in range(iterations):
        r, dP, Xc = residuals(R, t)
        wt, _ = _robust_weights(r, stereo, w2, valid)
        # d Xc / d (v, w) under a left perturbation: [I | -[Xc]x]
        dX = torch.cat([torch.eye(3, dtype=dtype, device=dev).expand(
            *Xc.shape[:-1], 3, 3), -_hat(Xc)], -1)
        J = (dP * rows[..., None]) @ dX                      # (B, N, 3, 6)
        H = torch.einsum("bnki,bn,bnkj->bij", J, wt, J)
        g = torch.einsum("bnki,bn,bnk->bi", J, wt, r)
        if rotation is not None:
            # the rotation rows of the twist (translation, rotation)
            rp, Jp = rotation_terms(R, *rotation[:2])
            wp = rotation[2]
            H[:, 3:, 3:] += torch.einsum("bkci,bk,bkcj->bij", Jp, wp, Jp)
            g[:, 3:] += torch.einsum("bkci,bk,bkc->bi", Jp, wp, rp)
        d = -_solve(H, g)
        cost0 = cost(r, R)

        def moved(step):
            Rd, td = se3_exp(d * step[:, None])
            return Rd @ R, (Rd @ t[..., None])[..., 0] + td

        def cost_at(step):
            Rm, tm = moved(step)
            return cost(residuals(Rm, tm)[0], Rm)

        step = _line_search(cost0, cost_at, d)
        R, t = moved(step)
        if _converged(d * step[:, None], t):
            break
    T = torch.zeros_like(T0)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T


def solve_points(P0, poses, uv, right, w2, valid, cam, bf, dtype,
                 iterations: int = 50):
    """Point-only optima of P points: P0 (P, 3), poses (P, M, 4, 4) of the
    observing cameras, uv (P, M, 2), right / w2 / valid (P, M).  Returns
    (P, 3) in ``dtype``."""
    dev = P0.device
    P0, poses, uv, right, w2 = (t.to(dev, dtype) for t in
                                (P0, poses, uv, right, w2))
    valid = valid.to(dev)
    cam = tuple(torch.tensor(c, dtype=dtype, device=dev) for c in cam)
    bf = torch.tensor(bf, dtype=dtype, device=dev)
    stereo = right > 0
    rows = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo),
                        stereo], -1).to(dtype)
    obs = torch.cat([uv, right[..., None]], -1)
    R, t = poses[..., :3, :3], poses[..., :3, 3]
    X = P0

    def residuals(X):
        Xc = (R @ X[:, None, :, None])[..., 0] + t
        pred, dP = _project(Xc, cam, bf)
        return (pred - obs) * rows, dP

    for _ in range(iterations):
        r, dP = residuals(X)
        wt, _ = _robust_weights(r, stereo, w2, valid)
        J = (dP * rows[..., None]) @ R                       # (P, M, 3, 3)
        H = torch.einsum("pmki,pm,pmkj->pij", J, wt, J)
        g = torch.einsum("pmki,pm,pmk->pi", J, wt, r)
        d = -_solve(H, g)
        cost = _huber_cost(r, stereo, w2, valid)
        step = _line_search(cost, lambda st: _huber_cost(
            residuals(X + d * st[:, None])[0], stereo, w2, valid), d)
        X = X + d * step[:, None]
        if _converged(d * step[:, None], X):
            break
    return X


def centres(T: torch.Tensor) -> torch.Tensor:
    """Camera centres -R^T t of world -> camera poses (..., 4, 4)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def unproject(uv, depth, cam):
    """Camera-frame points of pixels ``uv`` (N, 2) at ``depth`` (N,)."""
    fx, fy, cx, cy = cam
    return torch.stack([(uv[:, 0] - cx) / fx * depth,
                        (uv[:, 1] - cy) / fy * depth, depth], -1)


def gap_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance in mm between points in metres, in float64."""
    return torch.linalg.norm(a.double() - b.double(), dim=-1) * 1e3



def pose_costs(T, points, uv, right, w2, valid, cam, bf,
               rotation=None) -> torch.Tensor:
    """The robust cost (sum of Huber-robustified weighted chi2) of B pose
    problems at poses ``T`` (B, 4, 4), with their rotation terms' where
    given (as ``solve_poses``), in float64."""
    dt = torch.float64
    dev = T.device
    T, points, uv, right, w2 = (t.to(dev, dt) for t in
                                (T, points, uv, right, w2))
    valid = valid.to(dev)
    cam = tuple(torch.tensor(c, dtype=dt, device=dev) for c in cam)
    bf = torch.tensor(bf, dtype=dt, device=dev)
    stereo = right > 0
    rows = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo),
                        stereo], -1).to(dt)
    obs = torch.cat([uv, right[..., None]], -1)
    Xc = (T[:, None, :3, :3] @ points[..., None])[..., 0] + T[:, None, :3, 3]
    pred, _ = _project(Xc, cam, bf)
    cost = _huber_cost((pred - obs) * rows, stereo, w2, valid)
    if rotation is not None:
        cost = cost + rotation_cost(T[:, :3, :3],
                                    *(x.to(dev, dt) for x in rotation))
    return cost


def point_costs(X, poses, uv, right, w2, valid, cam, bf) -> torch.Tensor:
    """The robust cost of P points ``X`` (P, 3) over their observations
    (as ``solve_points``), in float64."""
    dt = torch.float64
    dev = X.device
    X, poses, uv, right, w2 = (t.to(dev, dt) for t in
                               (X, poses, uv, right, w2))
    valid = valid.to(dev)
    cam = tuple(torch.tensor(c, dtype=dt, device=dev) for c in cam)
    bf = torch.tensor(bf, dtype=dt, device=dev)
    stereo = right > 0
    rows = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo),
                        stereo], -1).to(dt)
    obs = torch.cat([uv, right[..., None]], -1)
    Xc = (poses[..., :3, :3] @ X[:, None, :, None])[..., 0] + poses[..., :3, 3]
    pred, _ = _project(Xc, cam, bf)
    return _huber_cost((pred - obs) * rows, stereo, w2, valid)


def ate_mm(est: torch.Tensor, gt: torch.Tensor) -> float:
    """Absolute trajectory error in mm: the RMS distance of the estimated
    positions ``est`` (N, 3) from the true ones ``gt`` after the
    similarity (scale, rotation, translation) that best maps ``est`` onto
    ``gt`` (Umeyama 1991), in float64."""
    x, y = est.double(), gt.double()
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    S = yc.T @ xc / len(x)
    U, D, Vt = torch.linalg.svd(S)
    E = torch.eye(3, dtype=torch.float64)
    if torch.det(U) * torch.det(Vt) < 0:
        E[2, 2] = -1.0
    R = U @ E @ Vt
    var = (xc ** 2).sum(-1).mean()
    s = (D * E.diagonal()).sum() / var if var > 0 else torch.tensor(1.0)
    aligned = s * (x @ R.T) + (my - s * (R @ mx))
    return float(torch.sqrt(((aligned - y) ** 2).sum(-1).mean()) * 1e3)
