"""Batched NMPC trajectory-optimization solver.

Port of ``irbfn_tpu/solvers/nmpc.py``. Solves the Frenet-frame NMPC problem

    min_{U}  sum_{k=0}^{T-1} (x_k - x_g)^T Q (x_k - x_g) + u_k^T R u_k
    s.t.     x_{k+1} = RK4(x_k, u_k; curv),  x_0 given
             u in [u_lo, u_hi]   (accel, steer-vel boxes)
             delta_k, vx_k in state boxes

and its Cartesian and kinematic variants, for a whole batch of problems at
once:

- **single shooting**: the RK4 equalities are eliminated by rolling the
  dynamics forward, leaving a 10-dim decision vector (T=5 steps x 2
  controls) per problem;
- **projected semi-smooth Newton** with LM damping on the free set, the
  control boxes enforced by projection (clip);
- **augmented Lagrangian** on the state boxes (delta, vx);
- failures surface as a feasibility mask (the table writer turns it into
  -999 sentinel rows) plus the active-constraint one-hot in the 86-wide
  ``lam_g`` layout.

Where the JAX package writes one problem and lifts it with ``vmap``, every
function here is natively batched over leading row axes with the same
arithmetic per row: a row's result does not depend on the rows solved beside
it. The ``lax.while_loop`` under ``vmap`` becomes a host loop of at most
``gn_iters`` passes in which a row that has converged is frozen (its
iterate, damping and flag no longer change) and which ends early once every
row has converged. The derivatives of an iteration (the exact Hessian of
the smooth cost, the Jacobian of the walls) come from reverse-mode autograd
over one batched evaluation of the dynamics (``_fused_derivatives``);
nothing is compiled per batch shape.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.frenet import frenet_deriv
from irbfn_tpu_torch.dynamics.params import VehicleParams
from irbfn_tpu_torch.dynamics.single_track import st_mixed_deriv


@dataclass(frozen=True)
class NMPCConfig:
    """Frenet NMPC problem constants (the reference's mpc_config)."""

    horizon: int = 5
    dt: float = 0.1
    q_diag: tuple = (0.0, 65.0, 0.0, 0.5, 5.0, 0.0, 15.0)
    r_diag: tuple = (0.01, 1.0)
    # terminal-state weight: the Frenet problem has none (cost stages are
    # X[:, 0..T-1]); the Cartesian problem adds Qf on X[:, T]
    qf_diag: tuple | None = None
    # dynamics model: "frenet" (speed-switched Frenet single track),
    # "cartesian" (tanh-blended single track) or "kinematic"
    model: str = "frenet"
    # boxes
    max_accel: float = 9.51
    max_dsteer: float = math.pi
    max_steer: float = 0.4189
    max_speed: float = 10.0
    min_speed: float = 0.0
    v_switch: float = 1.0
    # solver: moderate penalty growth. The AL multipliers carry constraint
    # enforcement; a large final rho makes the max(0, .)^2 walls so stiff
    # that Newton steps bounce across the kink and stall. Raise the
    # iteration budget for offline gold runs.
    gn_iters: int = 25
    al_outer: int = 4
    penalty0: float = 100.0
    penalty_growth: float = 4.0
    linesearch_steps: int = 8
    # multiplier tolerance used for the activation one-hot
    active_tol: float = 1e-6
    # relative-KKT threshold above which a solve is flagged infeasible, the
    # analogue of an interior-point solver's convergence failure
    kkt_tol: float = 5e-2


class NMPCSolution(NamedTuple):
    accel: torch.Tensor  # (..., T)
    steer_vel: torch.Tensor  # (..., T)
    states: torch.Tensor  # (..., T+1, 7) rolled-out trajectory
    active_onehot: torch.Tensor  # (..., 86) lam_g layout (1 = inactive)
    feasible: torch.Tensor  # bool (...,), replaces -999 sentinels
    kkt_residual: torch.Tensor  # (...,) relative projected-gradient norm


def _lift_params(p: VehicleParams, extra: int) -> VehicleParams:
    """Per-row parameter fields ``(B,)`` get ``extra`` trailing axes, so
    that they broadcast against ``(B, ...)`` batches of candidates; 0-dim
    fields pass through."""
    if extra == 0:
        return p
    idx = (...,) + (None,) * extra
    return VehicleParams(*[f[idx] if f.ndim else f for f in p.fields()])


def _deriv_fn(curv, p: VehicleParams, cfg: NMPCConfig):
    """The solver-side dynamics ``(x, u) -> dx/dt`` of ``cfg.model``."""
    if cfg.model == "cartesian":
        def deriv(x, uk):
            return st_mixed_deriv(x, uk, p)
    elif cfg.model == "kinematic":
        def deriv(x, uk):
            # pure kinematic bicycle in the 7-dim layout (the psi_dot and
            # beta slots are inert)
            v, psi, delta = x[..., 3], x[..., 4], x[..., 2]
            zero = torch.zeros_like(v)
            return torch.stack(
                [v * torch.cos(psi), v * torch.sin(psi), uk[..., 1],
                 uk[..., 0], v * torch.tan(delta) / (p.lf + p.lr), zero,
                 zero], dim=-1)
    elif cfg.model == "frenet":
        def deriv(x, uk):
            # saturate=False: the solver's dynamics take raw variables
            # (bounds are constraints, not clips); the clip kinks coincide
            # with the solver's box bounds and make spurious nonsmooth
            # minima
            return frenet_deriv(x, uk, curv, p, blend="switch",
                                v_switch=cfg.v_switch, saturate=False)
    else:
        raise ValueError(f"unknown model {cfg.model!r}")
    return deriv


def _rk4_step(deriv, x, uk, dt: float):
    k1 = deriv(x, uk)
    k2 = deriv(x + 0.5 * dt * k1, uk)
    k3 = deriv(x + 0.5 * dt * k2, uk)
    k4 = deriv(x + dt * k3, uk)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _rollout_rk4(x0, u, curv, p: VehicleParams, cfg: NMPCConfig):
    """RK4 roll of ``(..., T, 2)`` controls from ``x0`` ``(..., 7)`` at
    curvature ``(...,)``. Returns ``(..., T+1, 7)``."""
    deriv = _deriv_fn(curv, p, cfg)
    x = x0
    xs = [x0]
    for k in range(u.shape[-2]):
        x = _rk4_step(deriv, x, u[..., k, :], cfg.dt)
        xs.append(x)
    return torch.stack(xs, dim=-2)


def _controls(u_flat, cfg: NMPCConfig):
    return u_flat.reshape(u_flat.shape[:-1] + (cfg.horizon, 2))


def _cost_of_states(xs, u, goal, cfg: NMPCConfig):
    """The tracking + control cost of an already rolled-out trajectory."""
    T = cfg.horizon
    q = torch.as_tensor(cfg.q_diag, dtype=u.dtype, device=u.device)
    r = torch.as_tensor(cfg.r_diag, dtype=u.dtype, device=u.device)
    dx = xs[..., 1:T, :] - goal[..., None, :]
    cost = (q * dx * dx).sum(dim=(-2, -1)) + (r * u * u).sum(dim=(-2, -1))
    if cfg.qf_diag is not None:
        qf = torch.as_tensor(cfg.qf_diag, dtype=u.dtype, device=u.device)
        dterm = xs[..., T, :] - goal
        cost = cost + (qf * dterm * dterm).sum(dim=-1)
    return cost


def _smooth_cost(u_flat, x0, goal, curv, p, cfg: NMPCConfig):
    """Tracking + control cost (no constraint terms), ``(...,)``.

    Cost stages follow the reference exactly: states k=1..T-1 against the
    goal; the terminal state is not in the cost unless ``qf_diag`` is set.
    """
    u = _controls(u_flat, cfg)
    xs = _rollout_rk4(x0, u, curv, p, cfg)
    return _cost_of_states(xs, u, goal, cfg)


def _state_box_violations(xs, cfg: NMPCConfig):
    delta = xs[..., 2]
    vx = xs[..., 3]
    return torch.cat([
        delta - cfg.max_steer,
        -cfg.max_steer - delta,
        vx - cfg.max_speed,
        cfg.min_speed - vx,
    ], dim=-1)


def _walls_of_states(xs, lam_state, rho, cfg: NMPCConfig):
    g = _state_box_violations(xs, cfg)  # (..., 4*(T+1))
    rho = torch.as_tensor(rho, dtype=xs.dtype, device=xs.device)
    return torch.sqrt(0.5 * rho) * torch.clamp(lam_state / rho + g, min=0.0)


def _wall_residuals(u_flat, x0, curv, lam_state, rho, p, cfg: NMPCConfig):
    """AL state-box residuals: sqrt(rho/2) max(0, lam/rho + g)."""
    xs = _rollout_rk4(x0, _controls(u_flat, cfg), curv, p, cfg)
    return _walls_of_states(xs, lam_state, rho, cfg)


def _objective_and_states(u_flat, x0, goal, curv, lam_state, rho, p,
                          cfg: NMPCConfig):
    u = _controls(u_flat, cfg)
    xs = _rollout_rk4(x0, u, curv, p, cfg)
    w = _walls_of_states(xs, lam_state, rho, cfg)
    return _cost_of_states(xs, u, goal, cfg) + (w * w).sum(dim=-1), xs


def _objective(u_flat, x0, goal, curv, lam_state, rho, p, cfg: NMPCConfig):
    return _objective_and_states(u_flat, x0, goal, curv, lam_state, rho, p,
                                 cfg)[0]


def _control_bounds(cfg: NMPCConfig, dtype, device=None):
    lo = torch.tensor([-cfg.max_accel, -cfg.max_dsteer], dtype=dtype,
                      device=device)
    hi = torch.tensor([cfg.max_accel, cfg.max_dsteer], dtype=dtype,
                      device=device)
    return lo, hi


def _fused_derivatives(u, x0, goal, curv, lam, rho, p, cfg: NMPCConfig,
                       xs=None):
    """Every derivative of a Newton iteration for a batch of rows ``u``
    ``(B, n)``: ``H_s`` ``(B, n, n)`` (the exact Hessian of the smooth
    cost), ``Jw`` ``(B, m, n)`` (the Jacobian of the wall residuals), and
    the primal ``v`` ``(B,)``, ``gs`` ``(B, n)``, ``w`` ``(B, m)``: what the
    JAX package takes from one ``jacfwd`` over ``(grad of the smooth cost,
    wall residuals)`` through the rollout, computed here from ONE batched
    evaluation of the dynamics (the tests hold it against that form).

    Differentiating through the whole rollout visits its 4T dynamics
    evaluations one after the other, and in eager PyTorch every operation
    of every pass is a launch. Given the primal trajectory and its RK4
    stage points, the 4T evaluations ``f(y, u)`` are independent of each
    other, so they are differentiated as ONE batch ``(B, T, 4)``, and the
    chain rule through stages and steps is a few small matrix products:

    1. reverse mode gives every evaluation's Jacobian ``Df`` (7 x 9), one
       batched cotangent per output; the stage recursion
       ``K_i = Df_i W_i``, ``W_i = d(y_i, u)/dz`` assembles every step's
       Jacobian ``A_k = dF/dz``, ``z = (x_k, u_k)``;
    2. a backward recursion over steps gives the costates
       ``l_k = d(cost to go)/dx_k = dl_k/dx + Ax_k^T l_{k+1}``, and one over
       stages the weight ``nu_i`` with which ``k_i`` enters ``l_{k+1} . F``
       (directly, and through the later stages' points);
    3. reverse over reverse, on the graph of the same evaluation, gives the
       9 x 9 Hessians of the scalars ``nu_i . f`` at the stage points, and
       ``M_k = sum_i W_i^T Hess_i W_i`` is the Hessian of ``l_{k+1} . F``;
    4. a forward recursion gives the sensitivities ``Z_k = dz_k/du``.

    Then ``H_s = sum_k Z_k^T (M_k + d2l_k/dz2) Z_k`` exactly (the chain
    rule's second-order terms are the costate-weighted Hessians), the
    gradient's block for ``u_k`` is ``dl_k/du + Au_k^T l_{k+1}``, and the
    wall Jacobian reads rows of ``Z``. ``xs``: the rollout of ``u`` where
    the caller already has it (the line search rolled out the accepted
    candidate).

    (Reverse mode throughout: PyTorch's forward mode pays a host-side
    shape computation for every product with an operand that carries no
    tangent, several times the cost of the operation itself.)
    """
    T = cfg.horizon
    B, n = u.shape
    dtype, dev = u.dtype, u.device
    dt = cfg.dt
    uc = _controls(u, cfg)
    if xs is None:
        xs = _rollout_rk4(x0, uc, curv, p, cfg)  # (B, T+1, 7)
    v = _cost_of_states(xs, uc, goal, cfg)
    w = _walls_of_states(xs, lam, rho, cfg)

    # the RK4 stage points of every step, all steps at once
    deriv = _deriv_fn(curv[:, None].expand(B, T), _lift_params(p, 1), cfg)
    xk = xs[:, :T]
    k1 = deriv(xk, uc)
    k2 = deriv(xk + 0.5 * dt * k1, uc)
    k3 = deriv(xk + 0.5 * dt * k2, uc)
    ys = torch.stack([xk, xk + 0.5 * dt * k1, xk + 0.5 * dt * k2,
                      xk + dt * k3], dim=2)  # (B, T, 4, 7)
    z4 = torch.cat([ys, uc[:, :, None, :].expand(B, T, 4, 2)], dim=-1)
    deriv4 = _deriv_fn(curv[:, None, None].expand(B, T, 4),
                       _lift_params(p, 2), cfg)

    def batched_grad(out, basis):
        # rows of d(out)/dz: one cotangent per basis row, every evaluation
        # (B, T, 4) at once (they do not depend on each other)
        k = basis.shape[0]
        return torch.autograd.grad(
            out, zr, grad_outputs=basis[:, None, None, None, :].expand(
                (k,) + tuple(out.shape)),
            is_grads_batched=True, retain_graph=True)[0]

    with torch.enable_grad():
        zr = z4.detach().requires_grad_(True)
        f4 = deriv4(zr[..., :7], zr[..., 7:])  # (B, T, 4, 7)
        Df = batched_grad(f4, torch.eye(7, dtype=dtype, device=dev))
    Df = Df.permute(1, 2, 3, 0, 4)  # (B, T, 4, 7, 9)

    # stage recursion: W_i = d(y_i, u)/dz (9 x 9), K_i = dk_i/dz = Df_i W_i
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    Ix = eye9[:7]  # dx/dz
    step_h = (0.5 * dt, 0.5 * dt, dt)
    Ws = [eye9.expand(B, T, 9, 9)]
    Ks = [Df[:, :, 0]]
    for i in range(1, 4):
        Wi = torch.cat([Ix + step_h[i - 1] * Ks[i - 1],
                        eye9[7:].expand(B, T, 2, 9)], dim=-2)
        Ws.append(Wi)
        Ks.append(Df[:, :, i] @ Wi)
    A = Ix + (dt / 6.0) * (Ks[0] + 2.0 * Ks[1] + 2.0 * Ks[2] + Ks[3])
    Ax = A[..., :7]  # (B, T, 7, 7)

    # stage-cost derivatives: dl_k/dx = 2 q (x_k - g) on stages 1..T-1 (and
    # 2 qf (x_T - g) at the end), d2l_k/dz2 = diag(2 q [1 <= k <= T-1], 2 r)
    q = torch.as_tensor(cfg.q_diag, dtype=dtype, device=dev)
    r = torch.as_tensor(cfg.r_diag, dtype=dtype, device=dev)
    dldx = 2.0 * q * (xs - goal[:, None, :])  # (B, T+1, 7)
    if cfg.qf_diag is not None:
        qf = torch.as_tensor(cfg.qf_diag, dtype=dtype, device=dev)
        l_next = 2.0 * qf * (xs[:, T] - goal)
    else:
        qf = torch.zeros_like(q)
        l_next = torch.zeros((B, 7), dtype=dtype, device=dev)
    costates = [None] * T  # costates[k] = l_{k+1}
    for k in range(T - 1, -1, -1):
        costates[k] = l_next
        if k >= 1:
            l_next = dldx[:, k] + (Ax[:, k].transpose(-1, -2)
                                   @ l_next[..., None])[..., 0]
    L = torch.stack(costates, dim=1)  # (B, T, 7)

    # the weight of each stage's k_i in L . F: its own RK4 coefficient, and
    # what it adds to the later stages through their points
    DfxT = Df[..., :7].transpose(-1, -2)  # (B, T, 4, 7, 7)
    nus = [None] * 4
    nus[3] = (dt / 6.0) * L
    coef = (dt / 6.0, dt / 3.0, dt / 3.0)
    for i in (2, 1, 0):
        nus[i] = coef[i] * L + step_h[i] * (
            DfxT[:, :, i + 1] @ nus[i + 1][..., None])[..., 0]
    nu = torch.stack(nus, dim=2)  # (B, T, 4, 7)

    with torch.enable_grad():
        gz = torch.autograd.grad((nu * f4).sum(), zr, create_graph=True)[0]
        Hs4 = batched_grad(gz, eye9)
    Hs4 = Hs4.permute(1, 2, 3, 0, 4)  # (B, T, 4, 9, 9)
    W = torch.stack(Ws, dim=2)  # (B, T, 4, 9, 9)
    M = (W.transpose(-1, -2) @ Hs4 @ W).sum(dim=2)  # (B, T, 9, 9)

    Au = A[..., 7:]  # (B, T, 7, 2)
    gs = (2.0 * r * uc
          + (Au.transpose(-1, -2) @ L[..., None])[..., 0]).reshape(B, n)

    # sensitivities Z_k = dz_k/du = [S_k; E_k], S_{k+1} = A_k Z_k
    E = torch.eye(n, dtype=dtype, device=dev).reshape(T, 2, n)
    S = torch.zeros((B, 7, n), dtype=dtype, device=dev)
    Ss, Zs = [S], []
    for k in range(T):
        Zk = torch.cat([S, E[k].expand(B, 2, n)], dim=1)  # (B, 9, n)
        Zs.append(Zk)
        S = A[:, k] @ Zk
        Ss.append(S)
    Z = torch.stack(Zs, dim=1)  # (B, T, 9, n)
    S_all = torch.stack(Ss, dim=1)  # (B, T+1, 7, n)

    stage = torch.ones(T, dtype=dtype, device=dev)
    stage[0] = 0.0
    d2l = torch.cat([2.0 * q * stage[:, None], (2.0 * r).expand(T, 2)],
                    dim=-1)  # (T, 9)
    H_s = (Z.transpose(-1, -2) @ (M + torch.diag_embed(d2l)) @ Z).sum(dim=1)
    S_T = S_all[:, T]
    H_s = H_s + S_T.transpose(-1, -2) @ (2.0 * qf[:, None] * S_T)

    # wall Jacobian: the residuals' hinge is open where w > 0
    Sd, Sv = S_all[:, :, 2], S_all[:, :, 3]  # (B, T+1, n)
    dg = torch.cat([Sd, -Sd, Sv, -Sv], dim=1)  # (B, 4(T+1), n)
    rho_t = torch.as_tensor(rho, dtype=dtype, device=dev)
    Jw = torch.sqrt(0.5 * rho_t) * (w > 0).to(dtype)[..., None] * dg
    return H_s, Jw, v, gs, w


def _solve_spd(A, b):
    """Solve ``A x = b`` for a batch of small SPD systems ``(B, n, n)`` by
    Cholesky, in the JAX package's order of operations
    (``_solve_spd_unrolled``): column by column, each entry's products
    subtracted one at a time in ascending index order, then forward and
    back substitution in the same order. Every operation is elementwise
    over the batch, so a row's result does not depend on its neighbours or
    on the batch size, and a pivot is refused exactly where the JAX package
    refuses it: a negative pivot's square root is NaN, a zero pivot gives
    an infinite step, and the caller's line search rejects a step that is
    not finite (the LM-damping retry loop). No row's failure raises or
    touches another row.

    (LAPACK's blocked factorisation of ``cholesky_ex`` sums in another
    order; in f32 that moves which borderline pivots are taken, and the
    iterates of rows that the cheap pass leaves near its cap then part from
    the JAX package's.)"""
    n = A.shape[-1]
    cols = []  # cols[j]: (B, n - j), L[j:, j]
    for j in range(n):
        s = A[:, j:, j]
        for k in range(j):
            lk = cols[k][:, j - k:]  # L[j:, k]; its first entry is L[j, k]
            s = torch.addcmul(s, lk, lk[:, :1], value=-1.0)
        d = torch.sqrt(s[:, :1])
        cols.append(torch.cat([d, s[:, 1:] * (1.0 / d)], dim=1))
    # forward substitution L y = b, column-oriented: every y_i subtracts
    # its products in ascending k, as the JAX package's row loop does
    r = b
    ys = []
    for k in range(n):
        y = r[:, :1] / cols[k][:, :1]
        ys.append(y)
        r = torch.addcmul(r[:, 1:], cols[k][:, 1:], y, value=-1.0)
    # back substitution L^T x = y, row by row in ascending k
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        s = ys[i]
        for k in range(i + 1, n):
            s = torch.addcmul(s, cols[i][:, k - i:k - i + 1], xs[k],
                              value=-1.0)
        xs[i] = s / cols[i][:, :1]
    return torch.cat(xs, dim=1)


def _line_search(u, step, obj_cands, lo_flat, hi_flat, cfg: NMPCConfig):
    """Backtracking line search along the projected Newton direction, all
    trial points at once. The AL walls are piecewise quadratic, so a full
    step often crosses a kink and overshoots; halving recovers cheaply.
    Candidates that are not finite count as +inf. Returns the best
    candidate, its rolled-out states and its objective; the caller accepts
    it only where that objective is below the current one (a NaN is not)."""
    ts = 0.5 ** torch.arange(cfg.linesearch_steps, dtype=u.dtype,
                             device=u.device)
    cands = torch.minimum(torch.maximum(
        u[:, None] - ts[None, :, None] * step[:, None], lo_flat), hi_flat)
    f_cands, xs_cands = obj_cands(cands)
    f_cands = torch.where(torch.isfinite(cands).all(dim=-1), f_cands,
                          torch.full_like(f_cands, float("inf")))
    best = torch.argmin(f_cands, dim=1, keepdim=True)
    f_best = torch.gather(f_cands, 1, best)[:, 0]
    c_best = torch.gather(
        cands, 1, best[..., None].expand(-1, 1, cands.shape[-1]))[:, 0]
    xs_best = torch.gather(
        xs_cands, 1, best[..., None, None].expand(
            (-1, 1) + tuple(xs_cands.shape[2:])))[:, 0]
    return c_best, xs_best, f_best


# the counters of the last solve on this process, read by the profiler
LAST_SOLVE_STATS = {"newton_iterations": 0, "inner_solves": 0}


def _newton_iteration(u, xs, mu, done, lam, rho, prob, cfg: NMPCConfig):
    """One damped projected semi-smooth Newton pass at fixed multipliers
    over the carried ``(u, xs, mu, done)``: iterate ``(B, n)``, its rollout,
    LM damping ``(B,)`` and converged flags ``(B,)``. A converged row is
    frozen: its iterate, rollout and damping come back unchanged.

    Hessian model = exact Hessian of the smooth (tracking + control) cost
    + Gauss-Newton of the AL hinge walls. The exact smooth part is needed
    because the tracking residuals are large (pure GN underestimates the
    curvature ~100x here and line searches collapse); the GN wall part is
    needed because the exact wall Hessian vanishes on the inactive side of
    the C1 kink and exact-Newton steps crash through it.
    """
    x0, goal, curv, p, lo_flat, hi_flat = prob
    dtype = u.dtype
    # dtype-aware tolerance: 1e-10 relative is unreachable in f32 and would
    # pin every row at the iteration cap
    conv_tol = 100.0 * torch.finfo(dtype).eps
    tol_bnd = 1e-9
    p_c = _lift_params(p, 1)

    def obj_cands(c):
        lead = c.shape[:2]
        return _objective_and_states(
            c, x0[:, None].expand(lead + (7,)),
            goal[:, None].expand(lead + (7,)), curv[:, None].expand(lead),
            lam[:, None], rho, p_c, cfg)

    H_s, Jw, v, gs, w = _fused_derivatives(u, x0, goal, curv, lam, rho, p,
                                           cfg, xs=xs)
    JwT = Jw.transpose(-1, -2)
    g = gs + 2.0 * (JwT @ w[..., None])[..., 0]  # exact AL gradient
    # relative projected-gradient convergence test on the current iterate
    pg = u - torch.minimum(torch.maximum(u - g, lo_flat), hi_flat)
    done = done | (torch.linalg.norm(pg, dim=-1)
                   < conv_tol * (1.0 + torch.linalg.norm(g, dim=-1)))
    H = H_s + 2.0 * (JwT @ Jw)
    # two-metric projection: variables pinned at a bound with the gradient
    # pushing outward take a (clipped) gradient step; the reduced system is
    # solved on the free set only
    pinned = (((u - lo_flat < tol_bnd) & (g > 0.0))
              | ((hi_flat - u < tol_bnd) & (g < 0.0)))
    free = (~pinned).to(dtype)
    H_red = (H * free[:, :, None] * free[:, None, :]
             + torch.diag_embed(pinned.to(dtype)))
    # plain-identity LM damping: the smooth Hessian may be indefinite; then
    # the Cholesky fails, the step is NaN and rejected below, and mu grows
    # until A is SPD
    eye = torch.eye(u.shape[-1], dtype=dtype, device=u.device)
    A = H_red + mu[:, None, None] * eye
    step = _solve_spd(A, g)
    f_old = v + (w * w).sum(dim=-1)
    u_new, xs_new, f_new = _line_search(u, step, obj_cands, lo_flat, hi_flat,
                                        cfg)
    improved = f_new < f_old  # false where either is NaN
    accept = improved & ~done
    u = torch.where(accept[:, None], u_new, u)
    xs = torch.where(accept[:, None, None], xs_new, xs)
    mu = torch.where(done, mu, torch.where(
        improved, torch.clamp(mu * 0.2, min=1e-10),
        torch.clamp(mu * 10.0, max=1e10)))
    return u, xs, mu, done


def _inner(u, lam, rho, prob, cfg: NMPCConfig):
    """The inner solve at fixed multipliers: at most ``gn_iters`` Newton
    passes over the whole batch. Each pass freezes the rows that have
    converged, as the per-row loop condition does, and the loop ends once no
    row is left. Returns the iterate and its rollout."""
    x0, _, curv, p, _, _ = prob
    B = u.shape[0]
    mu = torch.full((B,), 1e-4, dtype=u.dtype, device=u.device)
    done = torch.zeros(B, dtype=torch.bool, device=u.device)
    LAST_SOLVE_STATS["inner_solves"] += 1
    xs = _rollout_rk4(x0, _controls(u, cfg), curv, p, cfg)
    for _ in range(cfg.gn_iters):
        if bool(done.all()):
            break
        LAST_SOLVE_STATS["newton_iterations"] += 1
        u, xs, mu, done = _newton_iteration(u, xs, mu, done, lam, rho, prob,
                                            cfg)
    return u, xs


def _activation_onehot(u, xs, lam_state, cfg: NMPCConfig):
    """Constraint-activation one-hot in the reference's ``lam_g`` layout
    (1 = multiplier ~ 0 = inactive).

    Order: initial-state equality (7), per-stage RK4 equalities (5 x 7),
    then U0 > lo, U0 < hi, U1 > lo, U1 < hi (5 each), then X2 > lo, X2 < hi,
    X3 > lo, X3 < hi (6 each): 86 entries.
    """
    T = cfg.horizon
    tol = cfg.active_tol
    dtype = u.dtype
    # equality multipliers are generically nonzero -> "active" -> 0
    eq = torch.zeros(u.shape[:-2] + (7 + 7 * T,), dtype=dtype,
                     device=u.device)

    def act(slack):
        # 1 when the constraint is slack (inactive), 0 when tight
        return (slack > tol).to(dtype)

    a, sv = u[..., 0], u[..., 1]
    delta, vx = xs[..., 2], xs[..., 3]
    return torch.cat([
        eq,
        act(a + cfg.max_accel),  # U0 > -a_max
        act(cfg.max_accel - a),  # U0 < a_max
        act(sv + cfg.max_dsteer),
        act(cfg.max_dsteer - sv),
        act(delta + cfg.max_steer),
        act(cfg.max_steer - delta),
        act(vx - cfg.min_speed),
        act(cfg.max_speed - vx),
    ], dim=-1)


@torch.no_grad()
def _solve_rows(x0, goal, curv, u_init, p: VehicleParams, cfg: NMPCConfig):
    """Projected-Newton AL solve of ``B`` problems: ``x0``, ``goal``
    ``(B, 7)``, ``curv`` ``(B,)``, ``u_init`` ``(B, T, 2)``; the fields of
    ``p`` are 0-dim or ``(B,)``."""
    from torch.func import grad

    T = cfg.horizon
    B = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    lo, hi = _control_bounds(cfg, dtype, device)
    lo_flat, hi_flat = lo.repeat(T), hi.repeat(T)
    prob = (x0, goal, curv, p, lo_flat, hi_flat)
    LAST_SOLVE_STATS.update(newton_iterations=0, inner_solves=0)

    lam = torch.zeros((B, 4 * (T + 1)), dtype=dtype, device=device)
    rho = torch.tensor(cfg.penalty0, dtype=dtype, device=device)
    u_flat = torch.minimum(torch.maximum(u_init.reshape(B, 2 * T), lo_flat),
                           hi_flat)
    for _ in range(cfg.al_outer):
        u_flat, xs = _inner(u_flat, lam, rho, prob, cfg)
        lam = torch.clamp(lam + rho * _state_box_violations(xs, cfg),
                          min=0.0)
        rho = rho * cfg.penalty_growth
    # one final inner solve at the last multiplier estimate, so that the
    # KKT diagnostic below is evaluated at a (lam, u) pair that is a
    # stationary point of the final AL subproblem
    rho_final = rho / cfg.penalty_growth
    u_flat, xs = _inner(u_flat, lam, rho_final, prob, cfg)
    u = _controls(u_flat, cfg)

    # diagnostics
    g_state = _state_box_violations(xs, cfg)
    grad_final = grad(lambda uu: _objective(
        uu, x0, goal, curv, lam, rho_final, p, cfg).sum())(u_flat)
    pg = u_flat - torch.minimum(torch.maximum(u_flat - grad_final, lo_flat),
                                hi_flat)
    # relative stationarity: tracking-cost gradients reach O(100), so
    # normalize by the gradient scale
    kkt = (torch.linalg.norm(pg, dim=-1)
           / (1.0 + torch.linalg.norm(grad_final, dim=-1)))
    max_viol = torch.clamp(g_state, min=0.0).amax(dim=-1)
    feasible = ((max_viol < 1e-3) & torch.isfinite(u_flat).all(dim=-1)
                & (kkt < cfg.kkt_tol))
    onehot = _activation_onehot(u, xs, lam, cfg)
    return NMPCSolution(u[..., 0], u[..., 1], xs, onehot, feasible, kkt)


def _as_input(a, device) -> torch.Tensor:
    """A tensor input stays where it is unless ``device`` names a place;
    anything else goes to ``resolve_device(device)`` (the card by default,
    with no fallback)."""
    if torch.is_tensor(a) and device is None:
        return a
    return torch.as_tensor(a, device=resolve_device(device))


def solve_nmpc_batch(x0, goal, curv, params: VehicleParams,
                     cfg: NMPCConfig = NMPCConfig(), u_init=None,
                     device=None) -> NMPCSolution:
    """Solve a batch of NMPC problems.

    Args:
        x0: initial states ``(..., 7)`` = [s, ey, delta, vx, vy, wz, epsi]
        goal: goal states, broadcast to ``(..., 7)`` (the table generator
            uses [0, 0, 0, vx_goal, 0, 0, 0])
        curv: path curvature, broadcast to ``(...,)``
        params: vehicle params; each field 0-dim (shared by the batch) or
            of the batch's shape (a value per row)
        u_init: warm start ``(..., T, 2)``; defaults to zeros
        device: where array-like inputs are put (None: the card); tensors
            stay where they are, and the solve runs where ``x0`` is
    Returns:
        NMPCSolution with the leading batch axes preserved.
    """
    x0 = _as_input(x0, device)
    dtype, dev = x0.dtype, x0.device
    batch_shape = x0.shape[:-1]
    goal = torch.as_tensor(goal, dtype=dtype, device=dev)
    curv = torch.as_tensor(curv, dtype=dtype, device=dev)
    if u_init is None:
        u_init = torch.zeros(batch_shape + (cfg.horizon, 2), dtype=dtype,
                             device=dev)
    else:
        u_init = torch.as_tensor(u_init, dtype=dtype, device=dev)
    x0f = x0.reshape(-1, 7)
    goalf = goal.expand(batch_shape + (7,)).reshape(-1, 7)
    curvf = curv.expand(batch_shape).reshape(-1)
    uf = u_init.reshape(-1, cfg.horizon, 2)
    pf = VehicleParams(*[
        f.to(dev).expand(batch_shape).reshape(-1) if f.ndim
        else f.to(dev) for f in map(torch.as_tensor, params.fields())])
    out = _solve_rows(x0f, goalf, curvf, uf, pf, cfg)
    return NMPCSolution(*[o.reshape(batch_shape + o.shape[1:]) for o in out])


def solve_lattice_point(row, params: VehicleParams,
                        cfg: NMPCConfig = NMPCConfig(),
                        device=None) -> NMPCSolution:
    """Table-generator ABI: rows ``[ey, delta, vx, vy, vx_goal, wz, epsi,
    curv]`` ``(..., 8)`` -> solutions toward the goal state
    [0, 0, 0, vx_goal, 0, 0, 0]."""
    row = _as_input(row, device)
    zeros = torch.zeros_like(row[..., 0])
    x0 = torch.stack([zeros, row[..., 0], row[..., 1], row[..., 2],
                      row[..., 3], row[..., 5], row[..., 6]], dim=-1)
    goal = torch.stack([zeros, zeros, zeros, row[..., 4], zeros, zeros,
                        zeros], dim=-1)
    return solve_nmpc_batch(x0, goal, row[..., 7], params, cfg)


def solve_lattice_multi_params(rows, params_batch: VehicleParams,
                               cfg: NMPCConfig = NMPCConfig(),
                               device=None) -> NMPCSolution:
    """Solve the same lattice under a batch of vehicle-parameter settings in
    one batch: the outer mu sweep of the table generator as a leading axis.

    Args:
        rows: (N, 8) frenet lattice rows.
        params_batch: VehicleParams whose fields carry a leading (M,) axis
            (a field may stay 0-dim where every setting shares it).
    Returns:
        NMPCSolution with leading axes (M, N).
    """
    rows = _as_input(rows, device)
    fields = [torch.as_tensor(f) for f in params_batch.fields()]
    m = max([f.shape[0] for f in fields if f.ndim] or [1])
    n = rows.shape[0]
    pb = VehicleParams(*[
        f.to(rows.device)[:, None].expand(m, n) if f.ndim else f
        for f in fields])
    return solve_lattice_point(rows[None].expand(m, n, rows.shape[-1]), pb,
                               cfg)


def cartesian_config(**overrides) -> NMPCConfig:
    """Cartesian NMPC problem constants: goal-reaching cost on (x, y, v),
    terminal Qf, tighter accel/speed boxes for the F1TENTH-scale car."""
    kw = dict(
        model="cartesian",
        q_diag=(18.5, 18.5, 0.0, 1.5, 0.0, 0.0, 0.0),
        qf_diag=(18.5, 18.5, 0.0, 1.5, 0.0, 0.0, 0.0),
        r_diag=(0.5, 4.0),
        max_accel=3.0,
        max_dsteer=math.pi,
        max_steer=0.4189,
        max_speed=6.0,
        min_speed=0.0,
    )
    kw.update(overrides)
    return NMPCConfig(**kw)


def kinematic_config(**overrides) -> NMPCConfig:
    """Kinematic goal-reaching NMPC: the same 7-dim layout with the pure
    kinematic bicycle as the model."""
    kw = dict(
        model="kinematic",
        q_diag=(18.5, 18.5, 0.0, 3.5, 0.1, 0.0, 0.0),
        qf_diag=(18.5, 18.5, 0.0, 3.5, 0.1, 0.0, 0.0),
        r_diag=(0.01, 100.0),
        max_accel=3.0,
        max_dsteer=math.pi,
        max_steer=0.4189,
        max_speed=7.0,
        min_speed=0.0,
    )
    kw.update(overrides)
    return NMPCConfig(**kw)


def solve_cartesian_point(row, params: VehicleParams,
                          cfg: NMPCConfig | None = None,
                          device=None) -> NMPCSolution:
    """Cartesian table-generator ABI: rows ``[v_car, x_goal, y_goal,
    t_goal, v_goal, beta, angv]`` -> solutions from
    x0 = [0, 0, 0, v_car, 0, angv, beta] toward
    goal = [x_g, y_g, 0, v_g, t_g, 0, 0]."""
    cfg = cfg or cartesian_config()
    row = _as_input(row, device)
    zeros = torch.zeros_like(row[..., 0])
    x0 = torch.stack([zeros, zeros, zeros, row[..., 0], zeros, row[..., 6],
                      row[..., 5]], dim=-1)
    goal = torch.stack([row[..., 1], row[..., 2], zeros, row[..., 4],
                        row[..., 3], zeros, zeros], dim=-1)
    return solve_nmpc_batch(x0, goal, zeros, params, cfg)


__all__ = ["NMPCConfig", "NMPCSolution", "cartesian_config",
           "kinematic_config", "solve_cartesian_point",
           "solve_lattice_multi_params", "solve_lattice_point",
           "solve_nmpc_batch"]
