"""Goal-reaching kinematic MPC as a condensed box QP, batched over families.

Port of ``irbfn_tpu/solvers/goal_mpc.py`` (the goal family, the row solve,
the lattice solve on one card or across the mesh's data axis, and the LTV
tracking MPC). Per problem: state [x, y, v, yaw] over T
steps, controls [accel, steer] over T steps, dynamics linearised at
(v = v_car, yaw = 0, steer = 0), a quadratic goal-tracking cost with control
and control-difference penalties, and boxed steering, acceleration, speed
and steering rate.

The states are condensed out, so each problem is a 16-dim box QP in the
controls whose matrices depend on the lattice point only through v_car:
every goal of a v_car family shares P, the constraint rows and one KKT
factorization, and each ADMM sweep over the family's goals is three small
products per row. ``condensed_family`` is batched over a ``(F,)`` v_car
tensor, and the ADMM loop is ``ops/admm.py:admm_solve``: the hand-written
CUDA kernel on the card, its plain version on the CPU. Every product stays
in exact f32 (lower-precision passes stall ADMM at r_prim ~1e-2).

Outputs follow the reference ABI: speed = v_car + a_0 dt, steer = delta_0;
goals are ordered (x_g, y_g, v_g, t_g), the state layout.

``solve_tracking_mpc`` is the waypoint tracker: per-step linearisations
along a predicted path, so every row is its own family (F = rows, G = 1),
and its sweeps are the same ``admm_solve`` launch.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.ops.admm import admm_solve
from irbfn_tpu_torch.solvers.qp import _mv
from irbfn_tpu_torch.utils import spans


class GoalMPCConfig(NamedTuple):
    """The reference node's mpc_config."""

    horizon: int = 8  # TK
    dt: float = 0.05  # DTK
    wheelbase: float = 0.33  # WB
    r_accel: float = 0.01  # Rk diag
    r_steer: float = 5.0
    rd_accel: float = 0.05  # Rdk diag
    rd_steer: float = 50.0
    q_state: tuple = (5.0, 5.0, 10.0, 1.0)  # Qk diag on [x, y, v, yaw]
    qf_state: tuple = (15.0, 15.0, 10.0, 1.0)  # Qfk diag
    max_steer: float = 0.4189
    max_dsteer: float = float(np.deg2rad(180.0))
    max_speed: float = 10.0
    min_speed: float = -2.0
    max_accel: float = 10.0


class GoalQPFamily(NamedTuple):
    """Condensed QP family for a batch of v_car linearization points; every
    field has the batch shape of v_car in front."""

    P: torch.Tensor  # (..., n, n) cost hessian, n = T*2
    A_con: torch.Tensor  # (..., m, n) constraint rows, m = 4T - 1
    lo: torch.Tensor  # (..., m)
    hi: torch.Tensor  # (..., m)
    Su: torch.Tensor  # (..., T*4, n) prediction map
    x_free: torch.Tensor  # (..., T*4) zero-control rollout of [0, 0, v, 0]
    qw: torch.Tensor  # (..., T*4) stacked stage/terminal state weights


class GoalMPCSolution(NamedTuple):
    speed: torch.Tensor  # (...,) reference ABI first-step outputs
    steer: torch.Tensor  # (...,)
    controls: torch.Tensor  # (..., T, 2) full [accel, steer] plan
    r_prim: torch.Tensor  # (...,) final primal residual (inf norm)
    r_dual: torch.Tensor  # (...,)
    converged: torch.Tensor  # (...,) bool


@functools.lru_cache(maxsize=16)
def _constants(cfg: GoalMPCConfig, dtype, device) -> dict:
    """The parts of a family that do not depend on v_car, built on the host
    once per (cfg, dtype, device) and copied to the device once: a family
    built afterwards launches only device kernels, with no host copy that
    would wait for the device."""
    T, nx, nu = cfg.horizon, 4, 2
    n = T * nu
    # control-difference operator D: (T-1)*nu rows of u_{k+1} - u_k
    D = np.zeros(((T - 1) * nu, n))
    steer_rows = np.zeros((T - 1, n))
    for k in range(T - 1):
        for c in range(nu):
            D[k * nu + c, (k + 1) * nu + c] = 1.0
            D[k * nu + c, k * nu + c] = -1.0
        steer_rows[k, (k + 1) * nu + 1] = 1.0
        steer_rows[k, k * nu + 1] = -1.0
    vel_sel = np.zeros((T, T * nx))
    for k in range(T):
        vel_sel[k, k * nx + 2] = 1.0
    host = dict(
        Ad0=np.array([[1, 0, cfg.dt, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], np.float64),
        dt=np.float64(cfg.dt), D=D, steer_rows=steer_rows, vel_sel=vel_sel,
        # stage weights: x_1..x_{T-1} get Qk, x_T gets Qfk (the x_0 term is
        # a constant in U and drops out of the argmin)
        qw=np.concatenate([np.tile(cfg.q_state, T - 1), cfg.qf_state]),
        r_diag=np.tile([cfg.r_accel, cfg.r_steer], T),
        rd_diag=np.tile([cfg.rd_accel, cfg.rd_steer], T - 1),
        u_lo=np.tile([-cfg.max_accel, -cfg.max_steer], T),
        u_hi=np.tile([cfg.max_accel, cfg.max_steer], T),
        d_bound=np.full(T - 1, cfg.max_dsteer * cfg.dt),
        v_lo=np.full(T, cfg.min_speed), v_hi=np.full(T, cfg.max_speed),
        eye_x=np.eye(nx), eye_u=np.eye(n))
    return {k: torch.as_tensor(a, dtype=dtype).to(device)
            for k, a in host.items()}


def _as_speed(v_car, dtype, device) -> torch.Tensor:
    """v_car as a tensor; a Python number is filled on the device (no host
    copy)."""
    if torch.is_tensor(v_car) or isinstance(v_car, np.ndarray):
        return torch.as_tensor(v_car, dtype=dtype, device=device)
    return torch.full((), float(v_car), dtype=dtype, device=device)


def condensed_family(v_car, cfg: GoalMPCConfig = GoalMPCConfig(),
                     dtype=torch.float32, device=None) -> GoalQPFamily:
    """The condensed QP family at linearization speed ``v_car``: a scalar,
    or a tensor of any batch shape (one family per entry)."""
    if torch.is_tensor(v_car) and device is None:
        device = v_car.device
    device = resolve_device(device)
    c = _constants(cfg, dtype, device)
    T, nx, nu = cfg.horizon, 4, 2
    n = T * nu
    v = _as_speed(v_car, dtype, device)
    batch = v.shape
    dt = c["dt"]

    # Ad/Bd at (v, yaw=0, steer=0); the affine term vanishes there
    Ad = c["Ad0"].expand(batch + (nx, nx)).clone()
    Ad[..., 1, 3] = dt * v  # dy/dyaw at yaw=0
    Bd = torch.zeros(batch + (nx, nu), dtype=dtype, device=device)
    Bd[..., 2, 0] = dt
    Bd[..., 3, 1] = dt * v / cfg.wheelbase

    # prediction: X = Sx x0 + Su U, X stacks x_1..x_T
    powers = [c["eye_x"].expand(batch + (nx, nx))]
    for _ in range(T):
        powers.append(Ad @ powers[-1])
    Sx = torch.cat(powers[1:], dim=-2)  # (..., T*nx, nx)
    Su = torch.zeros(batch + (T * nx, n), dtype=dtype, device=device)
    for k in range(1, T + 1):
        for j in range(k):
            Su[..., (k - 1) * nx:k * nx, j * nu:(j + 1) * nu] = (
                powers[k - 1 - j] @ Bd)

    qw, D = c["qw"], c["D"]
    W_Su = qw[:, None] * Su
    P = (Su.transpose(-1, -2) @ W_Su + torch.diag(c["r_diag"])
         + D.T @ (c["rd_diag"][:, None] * D))

    # constraints: [controls box; steer-rate rows; velocity rows]
    vel_rows = c["vel_sel"] @ Su  # v_k - v_car as a function of U
    A_con = torch.cat([c["eye_u"].expand(batch + (n, n)),
                       c["steer_rows"].expand(batch + (T - 1, n)), vel_rows],
                      dim=-2)
    lo = torch.cat([c["u_lo"].expand(batch + (n,)),
                    (-c["d_bound"]).expand(batch + (T - 1,)),
                    c["v_lo"] - v[..., None]], dim=-1)
    hi = torch.cat([c["u_hi"].expand(batch + (n,)),
                    c["d_bound"].expand(batch + (T - 1,)),
                    c["v_hi"] - v[..., None]], dim=-1)

    # unit constraint rows: mixed row scales (unit control boxes vs
    # ~dt*sqrt(k) velocity rows) wreck the single-rho ADMM
    row_norm = torch.sqrt(torch.sum(A_con * A_con, dim=-1))
    A_con = A_con / row_norm[..., None]
    lo = lo / row_norm
    hi = hi / row_norm

    x0 = torch.zeros(batch + (nx,), dtype=dtype, device=device)
    x0[..., 2] = v
    x_free = (Sx @ x0[..., None])[..., 0]
    return GoalQPFamily(P, A_con, lo, hi, Su, x_free,
                        qw.expand(batch + qw.shape))


def _goal_vector(fam: GoalQPFamily, goals, cfg: GoalMPCConfig):
    """Linear cost term q(goal) = Su' W (x_free - g_rep): goals of shape
    ``batch + (G, 4)``, columns (x_g, y_g, v_g, t_g), -> ``batch + (G, n)``."""
    g_rep = goals.repeat((1,) * (goals.ndim - 1) + (cfg.horizon,))
    resid = fam.x_free[..., None, :] - g_rep
    return (fam.qw[..., None, :] * resid) @ fam.Su


def _family_matrices(v_car, cfg, sigma, dtype, device):
    """What every goal of a family shares, for v_car of shape ``batch``:
    the family's matrices, the speed-scaled rho and the KKT inverse.

    On a card the build (~136 small launches) is one CUDA graph a (cfg,
    sigma, dtype, device, batch shape), kept in ``_OPERAND_GRAPHS``: the
    first call at a key captures it and answers with the eager build, every
    later call replays it (``_OperandGraph``). Elsewhere the build runs
    eagerly. Both run the same kernels, so both give the same bits. Every
    call is one ``goal.operands`` span and one ``goal.operand_builds``.
    """
    with spans.span("goal.operands"):
        spans.count("goal.operand_builds")
        device = resolve_device(device)
        if not _graphed(device):
            return _build_matrices(v_car, cfg, sigma, dtype, device)
        if device.index is None and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        key = (cfg, float(sigma), dtype, device, tuple(np.shape(v_car)))
        graph = _OPERAND_GRAPHS.get(key)
        if graph is None:
            spans.count("goal.operand_graph_captures")
            _OPERAND_GRAPHS.put(key, _OperandGraph(*key))
            return _build_matrices(v_car, cfg, sigma, dtype, device)
        spans.count("goal.operand_graph_replays")
        return graph(v_car)


def _graphed(device) -> bool:
    """Whether ``_family_matrices`` replays a graph: on a card."""
    return device.type == "cuda"


class _GraphCache:
    """The last ``size`` operand graphs used, by key (least recently used
    out first)."""

    def __init__(self, size: int):
        self.size = size
        self._graphs = collections.OrderedDict()

    def get(self, key):
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
        return graph

    def put(self, key, graph) -> None:
        self._graphs[key] = graph
        if len(self._graphs) > self.size:
            self._graphs.popitem(last=False)

    def __len__(self) -> int:
        return len(self._graphs)


_OPERAND_GRAPHS = _GraphCache(8)


class _OperandGraph:
    """``_build_matrices`` at one key, captured once as one CUDA graph.

    Set-up warms the build up on a side stream, then captures it on that
    stream (``capture_error_mode="thread_local"``: on a mesh, NCCL's
    watchdog thread queries events during the capture). Every graph of a
    device is captured on one stream, ``_capture_stream``: cuBLAS keeps a
    workspace a stream (32 MiB on an H100) for as long as the process
    lives, and the graphs' products use it. The graph reads v from a
    static input and writes every output into one flat buffer, each part
    at a 512-byte boundary. A call writes v into the input (``fill_`` or
    ``copy_``: no host copy of a number, no wait), replays the graph on the
    caller's stream and clones the flat buffer once: the tensors it returns
    are views of that clone, so a later replay leaves them as they were.
    Calls are ordered by the caller's stream, as eager launches are."""

    def __init__(self, cfg, sigma, dtype, device, shape):
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        align = 512 // self.v.element_size()
        with torch.cuda.device(device), torch.no_grad():
            stream = _capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                _build_matrices(self.v, cfg, sigma, dtype, device)
            torch.cuda.current_stream(device).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                fam, rho, kinv = _build_matrices(self.v, cfg, sigma, dtype,
                                                 device)
                parts = (*fam, rho, kinv)
                self.layout, n = [], 0
                for t in parts:
                    self.layout.append((n, t.shape))
                    n += -(-t.numel() // align) * align
                self.flat = torch.empty(n, dtype=dtype, device=device)
                for (at, shape), t in zip(self.layout, parts):
                    self.flat[at:at + t.numel()].view(shape).copy_(t)

    def __call__(self, v_car):
        if torch.is_tensor(v_car) or isinstance(v_car, np.ndarray):
            self.v.copy_(torch.as_tensor(v_car))
        else:
            self.v.fill_(float(v_car))
        self.graph.replay()
        flat = self.flat.clone()
        out = [flat[at:at + math.prod(shape)].view(shape)
               for at, shape in self.layout]
        return GoalQPFamily(*out[:-2]), out[-2], out[-1]


@functools.cache
def _capture_stream(device) -> torch.cuda.Stream:
    """The side stream on which every operand graph of ``device`` is
    warmed up and captured."""
    return torch.cuda.Stream(device)


def _build_matrices(v_car, cfg, sigma, dtype, device):
    """``_family_matrices`` as eager launches.

    rho law: in unit-row constraint coordinates with over-relaxation
    alpha = 1.6, rho grows with the linearization speed as max(1, |v|/2)
    (P's yaw-coupling curvature scales ~v^2).
    """
    fam = condensed_family(v_car, cfg, dtype, device)
    v = _as_speed(v_car, dtype, device)
    rho = torch.clamp(v.abs() * 0.5, min=1.0)
    eye = _constants(cfg, dtype, device)["eye_u"]
    kkt = fam.P + sigma * eye + rho[..., None, None] * (
        fam.A_con.transpose(-1, -2) @ fam.A_con)
    # PD by construction. No call here waits for the device: the _ex form
    # skips cholesky's check, and two triangular solves give
    # kinv = L^-T L^-1.
    chol, _ = torch.linalg.cholesky_ex(kkt)
    linv = torch.linalg.solve_triangular(chol, eye.expand(kkt.shape),
                                         upper=False)
    kinv = torch.linalg.solve_triangular(chol.transpose(-1, -2), linv,
                                         upper=True)
    return fam, rho, kinv


def _family_operands(v_car, goals, cfg, sigma):
    """``_family_matrices`` and the goal rows' linear terms, for goals of
    shape ``batch + (G, 4)``."""
    fam, rho, kinv = _family_matrices(v_car, cfg, sigma, goals.dtype,
                                      goals.device)
    return fam, rho, kinv, _goal_vector(fam, goals, cfg)


def _solve_families(v, goals, cfg, iters, sigma, tol,
                    matrices=None) -> GoalMPCSolution:
    """v (F,), goals (F, G, 4) -> a solution of shape (F, G); the families'
    ``_family_matrices`` are built here unless ``matrices`` holds them."""
    if matrices is None:
        matrices = _family_matrices(v, cfg, sigma, goals.dtype, goals.device)
    fam, rho, kinv = matrices
    q = _goal_vector(fam, goals, cfg)
    x, r_prim, r_dual = admm_solve(q.contiguous(), fam.A_con.contiguous(),
                                   kinv.contiguous(), fam.lo.contiguous(),
                                   fam.hi.contiguous(), rho.contiguous(),
                                   iters=iters, sigma=sigma)
    converged = (r_prim < tol) & (r_dual < tol)
    controls = x.reshape(x.shape[:2] + (cfg.horizon, 2))
    speed = v[:, None] + controls[..., 0, 0] * cfg.dt
    steer = controls[..., 0, 1]
    return GoalMPCSolution(speed, steer, controls, r_prim, r_dual, converged)


def _as_input(a, device) -> torch.Tensor:
    """A tensor input stays where it is unless ``device`` names a place;
    anything else goes to ``resolve_device(device)`` (the card by
    default)."""
    if torch.is_tensor(a) and device is None:
        return a
    return torch.as_tensor(a, device=resolve_device(device))


def solve_goal_family(v_car, goals, cfg: GoalMPCConfig = GoalMPCConfig(),
                      iters: int = 300, sigma: float = 1e-6,
                      tol: float = 2e-3, device=None) -> GoalMPCSolution:
    """Solve every goal in ``goals`` (G, 4) at linearization speed ``v_car``.

    One Cholesky of the 16x16 ADMM KKT for the whole family, then ``iters``
    fixed ADMM sweeps (one kernel launch on the card); ``converged`` reports
    the final inf-norm residuals against ``tol``. Runs in ``goals``' dtype.
    """
    goals = _as_input(goals, device)
    v = _as_speed(v_car, goals.dtype, goals.device).reshape(1)
    sol = _solve_families(v, goals[None], cfg, iters, sigma, tol)
    return GoalMPCSolution(*(t[0] for t in sol))


def solve_goal_mpc(inputs, cfg: GoalMPCConfig = GoalMPCConfig(),
                   iters: int = 300, device=None) -> GoalMPCSolution:
    """Reference-ABI row solve: inputs (N, 5) columns
    (v_car, x_goal, y_goal, t_goal, v_goal), each row with its own
    linearization: N one-goal families, solved by one ADMM launch."""
    inputs = torch.atleast_2d(_as_input(inputs, device))
    goals = torch.stack([inputs[:, 1], inputs[:, 2], inputs[:, 4],
                         inputs[:, 3]], dim=-1)  # (x_g, y_g, v_g, t_g)
    sol = _solve_families(inputs[:, 0], goals[:, None, :], cfg, iters,
                          1e-6, 2e-3)
    return GoalMPCSolution(*(t[:, 0] for t in sol))


def _lattice_chunk_fn(v_car, cfg: GoalMPCConfig, iters: int):
    """One family's chunk solve for the lattice pipeline: goal rows (B, 4)
    -> the table columns {speed, steer, converged} (B,). The family's
    matrices are built once, at the first chunk (one ``goal.operands`` span
    inside its ``lattice.solve``); every chunk then computes only its goals'
    linear terms and launches the sweeps on the same operands, the solve
    ``solve_goal_family`` makes of each chunk."""
    family = []

    def fn(g):
        if not family:
            v = _as_speed(v_car, g.dtype, g.device).reshape(1)
            family.append((v, _family_matrices(v, cfg, 1e-6, g.dtype,
                                               g.device)))
        v, matrices = family[0]
        sol = _solve_families(v, g[None], cfg, iters, 1e-6, 2e-3, matrices)
        return {"speed": sol.speed[0], "steer": sol.steer[0],
                "converged": sol.converged[0]}

    return fn


def solve_goal_lattice(v_car, goals, cfg: GoalMPCConfig = GoalMPCConfig(),
                       iters: int = 1200, batch_per_device: int = 262144,
                       device=None) -> dict:
    """One family's goal block (numpy (G, 4)) solved in chunks of
    ``batch_per_device`` goals on one device, with each chunk's copy back
    to the host overlapped with the next chunk's solve; the family's
    matrices are built once for all chunks. Returns the table columns as
    numpy arrays: {speed, steer, converged} (G,); the full control plans
    stay on the device."""
    from irbfn_tpu_torch.parallel.datagen import solve_lattice

    return solve_lattice(_lattice_chunk_fn(float(v_car), cfg, iters), goals,
                         batch_per_device=batch_per_device, device=device)


def solve_goal_lattice_sharded(v_car, goals,
                               cfg: GoalMPCConfig = GoalMPCConfig(),
                               iters: int = 1200, mesh=None,
                               batch_per_device: int = 262144,
                               progress: bool = False, device=None) -> dict:
    """``solve_goal_lattice`` across the mesh's data axis
    (``parallel/datagen.py:solve_lattice_sharded``): each rank solves its
    ``batch_per_device`` goals of every chunk, one ADMM launch of the family
    variant, with the family operands its own, built once a call; no
    collective runs inside the sweeps. The table columns {speed, steer,
    converged} (G,) are gathered, so that every rank returns all of them;
    at one rank they are ``solve_goal_lattice``'s bit for bit."""
    from irbfn_tpu_torch.parallel.datagen import solve_lattice_sharded

    return solve_lattice_sharded(_lattice_chunk_fn(float(v_car), cfg, iters),
                                 goals, mesh=mesh,
                                 batch_per_device=batch_per_device,
                                 progress=progress, device=device)


def solve_tracking_mpc(x0, ref_traj, path_predict,
                       cfg: GoalMPCConfig = GoalMPCConfig(),
                       iters: int = 600, sigma: float = 1e-6,
                       tol: float = 2e-3, device=None) -> GoalMPCSolution:
    """LTV trajectory-tracking kinematic MPC, batched over rows.

    Per-step linearisation at (v_t, phi_t) from ``path_predict`` with the
    affine C term, per-step references from ``ref_traj``, the goal family's
    cost and constraints except the velocity box [0, max_speed] (the
    tracker never reverses).

    Args:
        x0: (..., 4) initial state [x, y, v, yaw].
        ref_traj: (..., T+1, 4) reference states (row 0 is dropped: it is a
            constant with respect to the controls).
        path_predict: (..., T, 4) operating points; only v (column 2) and
            yaw (column 3) enter the model matrices.
    Returns:
        GoalMPCSolution (speed/steer first-step ABI and the control plan).

    The condensation, one 16x16 KKT inverse per row and the row
    normalisation are batched over the leading axes; the sweeps are one
    ``admm_solve`` launch with one family per row (rho = 1).
    """
    x0 = _as_input(x0, device)
    ref_traj = torch.as_tensor(ref_traj, dtype=x0.dtype, device=x0.device)
    path_predict = torch.as_tensor(path_predict, dtype=x0.dtype,
                                   device=x0.device)
    batch = x0.shape[:-1]
    x, r_prim, r_dual = admm_solve(
        *_tracking_operands(x0, ref_traj, path_predict, cfg, sigma),
        iters=iters, sigma=sigma)
    r_prim, r_dual = r_prim.reshape(batch), r_dual.reshape(batch)
    converged = (r_prim < tol) & (r_dual < tol)
    controls = x.reshape(batch + (cfg.horizon, 2))
    speed = x0[..., 2] + controls[..., 0, 0] * cfg.dt
    steer = controls[..., 0, 1]
    return GoalMPCSolution(speed, steer, controls, r_prim, r_dual, converged)


def _tracking_operands(x0, ref_traj, path_predict, cfg: GoalMPCConfig,
                       sigma: float):
    """The tracker's ADMM operands, one family per row of the flattened
    batch: (q (F, 1, n), A (F, m, n), kinv (F, n, n), lo (F, m), hi (F, m),
    rho (F,)), contiguous, in ``x0``'s dtype and device."""
    dtype, dev = x0.dtype, x0.device
    c = _constants(cfg, dtype, dev)
    T, nx, nu = cfg.horizon, 4, 2
    n = T * nu
    batch = x0.shape[:-1]
    dt = c["dt"]
    wb = cfg.wheelbase

    def model_mats(v, phi):
        """The model matrices at steer 0, batched."""
        z, o = torch.zeros_like(v), torch.ones_like(v)
        co, si = torch.cos(phi), torch.sin(phi)
        A = torch.stack([
            torch.stack([o, z, dt * co, -dt * v * si], -1),
            torch.stack([z, o, dt * si, dt * v * co], -1),
            torch.stack([z, z, o, z], -1),
            torch.stack([z, z, z, o], -1)], -2)  # (..., 4, 4)
        B = torch.stack([
            torch.stack([z, z], -1), torch.stack([z, z], -1),
            torch.stack([dt * o, z], -1),
            torch.stack([z, dt * v / wb], -1)], -2)  # (..., 4, 2)
        C = torch.stack([dt * v * si * phi, -dt * v * co * phi, z, z], -1)
        return A, B, C

    mats = [model_mats(path_predict[..., t, 2], path_predict[..., t, 3])
            for t in range(T)]

    # condense: x_k = Phi_k x0 + sum_j Phi_{k-1..j+1} (B_j u_j + C_j)
    blocks = [[None] * T for _ in range(T)]  # [k][j]
    x_aff = []
    phi_x = x0
    for k in range(T):
        A_k, B_k, C_k = mats[k]
        phi_x = _mv(A_k, phi_x) + C_k
        x_aff.append(phi_x)
        for j in range(k):
            blocks[k][j] = A_k @ blocks[k - 1][j]
        blocks[k][k] = B_k
    zero = torch.zeros(batch + (nx, nu), dtype=dtype, device=dev)
    Su = torch.cat([torch.cat([blocks[k][j] if j <= k else zero
                               for j in range(T)], dim=-1)
                    for k in range(T)], dim=-2)  # (..., T*nx, n)
    x_free = torch.cat(x_aff, dim=-1)  # (..., T*nx)

    qw, D = c["qw"], c["D"]
    ref_flat = ref_traj[..., 1:, :].reshape(batch + (T * nx,))
    q = ((qw * (x_free - ref_flat))[..., None, :] @ Su)[..., 0, :]
    P = (Su.transpose(-1, -2) @ (qw[:, None] * Su) + torch.diag(c["r_diag"])
         + D.T @ (c["rd_diag"][:, None] * D))

    vel_rows = c["vel_sel"] @ Su  # (..., T, n)
    A_con = torch.cat([c["eye_u"].expand(batch + (n, n)),
                       c["steer_rows"].expand(batch + (T - 1, n)), vel_rows],
                      dim=-2)  # (..., m, n)
    # the tracker's velocity box [0, max_speed] on the velocity state: the
    # bounds shift by the free rollout's velocities
    v_aff = _mv(c["vel_sel"], x_free)  # (..., T)
    lo = torch.cat([c["u_lo"].expand(batch + (n,)),
                    (-c["d_bound"]).expand(batch + (T - 1,)), -v_aff],
                   dim=-1)
    hi = torch.cat([c["u_hi"].expand(batch + (n,)),
                    c["d_bound"].expand(batch + (T - 1,)),
                    cfg.max_speed - v_aff], dim=-1)
    row_norm = torch.sqrt(torch.sum(A_con * A_con, dim=-1))
    A_con = A_con / row_norm[..., None]
    lo = lo / row_norm
    hi = hi / row_norm

    rho = 1.0
    kinv = torch.linalg.inv(P + sigma * c["eye_u"]
                            + rho * (A_con.transpose(-1, -2) @ A_con))
    m = A_con.shape[-2]
    F = int(np.prod(batch, dtype=np.int64))
    return (q.reshape(F, 1, n).contiguous(),
            A_con.reshape(F, m, n).contiguous(),
            kinv.reshape(F, n, n).contiguous(), lo.reshape(F, m).contiguous(),
            hi.reshape(F, m).contiguous(),
            torch.full((F,), rho, dtype=dtype, device=dev))
