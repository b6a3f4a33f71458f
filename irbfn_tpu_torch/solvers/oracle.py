"""Independent host-side NLP oracle for the batched NMPC solver.

Port of ``irbfn_tpu/solvers/oracle.py``. Cross-checks the AL/projected-Newton
solver (``solvers/nmpc.py``) against scipy's SLSQP sequential quadratic
programming solver, an NLP method with a completely independent convergence
path (active-set QP subproblems, its own line search and multiplier
estimates). The problem definition (single-shooting rollout, cost, boxes) is
shared with the batched solver on purpose: same problem, different solver,
so disagreement means a solver bug, not a modelling difference.

Everything runs in f64 on the CPU (scipy is host-side anyway); use small row
counts: this is a validation oracle, not a datagen path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import VehicleParams, fullscale_params
from irbfn_tpu_torch.solvers.nmpc import (NMPCConfig, _control_bounds,
                                          _controls, _rollout_rk4,
                                          _smooth_cost,
                                          _state_box_violations,
                                          solve_lattice_point)


class OracleResult(NamedTuple):
    u: np.ndarray  # (N, T, 2) controls
    objective: np.ndarray  # (N,) smooth cost at the solution
    max_violation: np.ndarray  # (N,) max state-box violation
    feasible: np.ndarray  # (N,) bool: converged + constraints satisfied


def _row_to_problem(row):
    """Frenet datagen row [ey, delta, vx, vy, vx_goal, wz, epsi, curv] ->
    (x0, goal, curv), the ``solve_lattice_point`` ABI."""
    x0 = np.array([0.0, row[0], row[1], row[2], row[3], row[5], row[6]])
    goal = np.zeros(7)
    goal[3] = row[4]
    return x0, goal, row[7]


def make_problem_fns(params: VehicleParams, cfg: NMPCConfig):
    """f64 (value + grad, constraints, constraint Jacobian) closures over
    (x0, goal, curv) for scipy, each taking and returning tensors. The
    rollout and cost are the exact functions the batched solver optimizes."""
    from torch.func import grad_and_value, jacrev

    def cost(u_flat, x0, goal, curv):
        return _smooth_cost(u_flat, x0, goal, curv, params, cfg)

    def cons(u_flat, x0, curv):
        xs = _rollout_rk4(x0, _controls(u_flat, cfg), curv, params, cfg)
        return -_state_box_violations(xs, cfg)  # scipy wants g(u) >= 0

    def vg(u_flat, x0, goal, curv):
        g, v = grad_and_value(cost)(u_flat, x0, goal, curv)
        return v, g

    return vg, cons, jacrev(cons)


def solve_oracle_rows(rows: np.ndarray, params: VehicleParams | None = None,
                      cfg: NMPCConfig = NMPCConfig(), maxiter: int = 300,
                      ftol: float = 1e-12) -> OracleResult:
    """Solve frenet lattice rows with scipy SLSQP (host loop, f64)."""
    from scipy.optimize import minimize

    params = params or fullscale_params(dtype=torch.float64, device="cpu")
    T = cfg.horizon
    vg, cf, cj = make_problem_fns(params, cfg)
    lo, hi = _control_bounds(cfg, torch.float64)
    bounds = [(float(lo[i % 2]), float(hi[i % 2])) for i in range(2 * T)]

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    us, objs, viols, feas = [], [], [], []
    for row in np.asarray(rows, np.float64):
        x0, goal, curv = (t64(a) for a in _row_to_problem(row))

        def f(u):
            v, g = vg(t64(u), x0, goal, curv)
            return float(v), g.numpy()

        res = minimize(
            f, np.zeros(2 * T), jac=True, method="SLSQP", bounds=bounds,
            constraints=[{
                "type": "ineq",
                "fun": lambda u: cf(t64(u), x0, curv).numpy(),
                "jac": lambda u: cj(t64(u), x0, curv).numpy(),
            }],
            options={"maxiter": maxiter, "ftol": ftol})
        g_final = cf(t64(res.x), x0, curv).numpy()
        max_viol = float(np.maximum(-g_final, 0.0).max())
        us.append(res.x.reshape(T, 2))
        objs.append(float(res.fun))
        viols.append(max_viol)
        feas.append(bool(res.success) and max_viol < 1e-6
                    and np.isfinite(res.fun))
    return OracleResult(np.stack(us), np.asarray(objs), np.asarray(viols),
                        np.asarray(feas))


def save_oracle(path, rows: np.ndarray, oracle: OracleResult,
                **provenance) -> None:
    """Persist an OracleResult as a committed test artifact: the expensive
    host-side SLSQP derivation runs once, and the suite compares the LIVE
    solver against the stored gold."""
    np.savez_compressed(
        path, rows=np.asarray(rows, np.float64), u=oracle.u,
        objective=oracle.objective, max_violation=oracle.max_violation,
        feasible=oracle.feasible,
        **{f"meta_{k}": np.asarray(v) for k, v in provenance.items()})


def load_oracle(path) -> tuple[np.ndarray, OracleResult]:
    """Load (rows, OracleResult) saved by ``save_oracle`` (either
    package's: the file layout is the same)."""
    z = np.load(path)
    return z["rows"], OracleResult(z["u"], z["objective"],
                                   z["max_violation"], z["feasible"])


def compare_to_oracle(rows: np.ndarray, params: VehicleParams | None = None,
                      cfg: NMPCConfig = NMPCConfig(),
                      oracle: OracleResult | None = None,
                      device=None, **oracle_kw) -> dict:
    """Solve rows with the batched solver (LIVE, f64, on ``device``; None:
    the card) and
    report agreement metrics against the SLSQP oracle, freshly derived
    unless a stored ``oracle`` is passed (see ``save_oracle``):

    - feasibility confusion (AL feasible vs oracle feasible)
    - on commonly-feasible rows: relative objective gap
      (J_al - J_oracle) / (1 + |J_oracle|), positive meaning the AL solver's
      point is worse; percentiles of per-row max |u_al - u_oracle|.

    All rows are solved as one batch. (The JAX package pads them into
    39-row chunks here to reuse one compiled program; PyTorch compiles
    nothing per shape, so no padding is needed.)
    """
    device = resolve_device(device)
    params = params or fullscale_params(dtype=torch.float64, device=device)
    rows = np.asarray(rows, np.float64)
    if oracle is None:
        oracle = solve_oracle_rows(rows, params.to("cpu"), cfg, **oracle_kw)
    sol = solve_lattice_point(torch.as_tensor(rows, device=device), params,
                              cfg)
    return agreement_metrics(rows, sol, oracle, params, cfg)


def agreement_metrics(rows: np.ndarray, sol, oracle: OracleResult,
                      params: VehicleParams, cfg: NMPCConfig) -> dict:
    """``compare_to_oracle``'s metrics for solutions ``sol`` of ``rows``
    that the batched solver has already made (on ``sol``'s device)."""
    rows = np.asarray(rows, np.float64)
    device = sol.accel.device
    rows_t = torch.as_tensor(rows, device=device)
    u_al = torch.stack([sol.accel, sol.steer_vel], dim=-1)
    feas_al = sol.feasible.cpu().numpy()

    # evaluate the AL solutions under the SAME objective
    zeros = torch.zeros_like(rows_t[:, 0])
    x0s = torch.stack([zeros, rows_t[:, 0], rows_t[:, 1], rows_t[:, 2],
                       rows_t[:, 3], rows_t[:, 5], rows_t[:, 6]], dim=-1)
    goals = torch.zeros_like(x0s)
    goals[:, 3] = rows_t[:, 4]
    j_al = _smooth_cost(u_al.reshape(len(rows), -1), x0s, goals,
                        rows_t[:, 7], params, cfg).cpu().numpy()
    u_al = u_al.cpu().numpy()

    both = feas_al & oracle.feasible
    rel_gap = ((j_al - oracle.objective)
               / (1.0 + np.abs(oracle.objective)))
    du = np.abs(u_al - oracle.u).reshape(len(rows), -1).max(axis=1)
    # control scale for a relative view: oracle u magnitude
    u_scale = np.abs(oracle.u).reshape(len(rows), -1).max(axis=1) + 1e-9

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else float("nan")

    return {
        "n_rows": int(len(rows)),
        "oracle_feasible": int(oracle.feasible.sum()),
        "al_feasible": int(feas_al.sum()),
        "both_feasible": int(both.sum()),
        "al_misses_oracle_feasible": int(
            (oracle.feasible & ~feas_al).sum()),
        "oracle_misses_al_feasible": int(
            (feas_al & ~oracle.feasible).sum()),
        "rel_obj_gap_p50": pct(rel_gap[both], 50),
        "rel_obj_gap_p90": pct(rel_gap[both], 90),
        "rel_obj_gap_max": float(rel_gap[both].max()) if both.any()
        else float("nan"),
        "du_max_p50": pct(du[both], 50),
        "du_max_p90": pct(du[both], 90),
        "du_rel_p90": pct((du / u_scale)[both], 90),
        "al_only_rel_gap": rel_gap,
        "both_mask": both,
    }
