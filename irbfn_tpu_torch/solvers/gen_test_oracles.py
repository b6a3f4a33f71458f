"""Derive the stored NMPC test oracles with the port.

Port of ``scripts/gen_test_oracles.py``. Two derivations, both in f64:

- the SLSQP oracle of the seeded 100-row fixture lattice
  (``nmpc_fixture_rows``, seed 7) through ``solvers/oracle.py`` (scipy on
  the host), written as ``nmpc_frenet_slsqp.npz``;
- the perturbation-optimality gold (``derive_perturbation_gold``): the two
  rows of the JAX package's ``tests/test_solvers.py`` solved by the batched
  f64 solver on ``--device``, then PROVEN optimal here: none of 60 random
  feasible perturbations of each solution improves the AL-free objective,
  written as ``nmpc_pert_gold.npz``.

The files land in ``--out_dir`` (default ``torch_runs/oracles``), in the
JAX package's layout, so that they can be compared with its committed
``tests/oracles/*.npz``; this module never writes there.

Usage: ``python -m irbfn_tpu_torch.solvers.gen_test_oracles [--device cpu]
[--out_dir torch_runs/oracles] [--n_rows 100]``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import fullscale_params
from irbfn_tpu_torch.solvers.nmpc import (NMPCConfig, _rollout_rk4,
                                          _smooth_cost, _state_box_violations,
                                          solve_lattice_point)
from irbfn_tpu_torch.solvers.oracle import save_oracle, solve_oracle_rows

# the fixture lattice of the JAX package's tests/test_nmpc_oracle.py
ORACLE_SEED = 7
ORACLE_ROWS = 100
# the perturbation-optimality rows of its tests/test_solvers.py, and the
# draw protocol of their proof
PERT_ROWS = np.array([
    [0.3, 0.05, 4.0, -0.1, 5.0, 0.4, 0.15, 0.03],
    [1.0, -0.1, 2.5, 0.3, 6.0, -1.0, -0.4, -0.08],
])
PERT_SEED = 0
PERT_CANDIDATES = 60


def nmpc_fixture_rows(n: int = ORACLE_ROWS,
                      seed: int = ORACLE_SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-0.2, 2.0, n),   # ey
        rng.uniform(-0.3, 0.3, n),   # delta
        rng.uniform(1.0, 7.0, n),    # vx
        rng.uniform(-1.0, 1.0, n),   # vy
        rng.uniform(3.0, 7.0, n),    # vx_goal
        rng.uniform(-2.6, 2.6, n),   # wz
        rng.uniform(-1.0, 1.0, n),   # epsi
        rng.uniform(-0.1, 0.1, n),   # curv
    ])


def perturbation_candidates(u_star: np.ndarray, cfg: NMPCConfig,
                            n_cand: int = PERT_CANDIDATES,
                            seed: int = PERT_SEED) -> np.ndarray:
    """``(rows, n_cand, 2T)`` clipped random perturbations of each row's
    solution, drawn in the JAX script's order: per row, per candidate, a
    scale from {1e-3, 1e-2, 1e-1}, then 2T unit normals."""
    rng = np.random.default_rng(seed)
    lo = np.tile([-cfg.max_accel, -cfg.max_dsteer], cfg.horizon)
    cands = np.zeros(u_star.shape[:1] + (n_cand,) + u_star.shape[1:])
    for b in range(u_star.shape[0]):
        for c in range(n_cand):
            scale = rng.choice([1e-3, 1e-2, 1e-1])
            cands[b, c] = np.clip(
                u_star[b] + scale * rng.standard_normal(u_star.shape[1]),
                lo, -lo)
    return cands


def derive_perturbation_gold(device=None, rows: np.ndarray = PERT_ROWS,
                             n_cand: int = PERT_CANDIDATES) -> dict:
    """Solve ``rows`` with the f64 solver on ``device`` (None: the card),
    evaluate the smooth cost and the worst state-box violation of each
    solution and of ``n_cand`` perturbations of it, and PROVE optimality:
    raise if any candidate is feasible (its violation at most the
    solution's + 1e-6) and improves the cost by more than 1e-6. Returns the
    gold's arrays (``nmpc_pert_gold.npz``'s keys)."""
    device = resolve_device(device)
    cfg = NMPCConfig()
    p = fullscale_params(dtype=torch.float64, device=device)
    r = torch.as_tensor(rows, dtype=torch.float64, device=device)
    sol = solve_lattice_point(r, p, cfg)
    if not bool(sol.feasible.all()):
        raise RuntimeError("the perturbation gold's rows must solve feasible")
    u_star = torch.stack([sol.accel, sol.steer_vel], -1).reshape(
        len(rows), -1).cpu().numpy()
    cands = perturbation_candidates(u_star, cfg, n_cand)

    # the solution and its candidates as one batch per row: (1 + n_cand, 2T)
    u_all = torch.as_tensor(np.concatenate([u_star[:, None], cands], 1),
                            device=device)
    zeros = torch.zeros_like(r[:, 0])
    x0 = torch.stack([zeros, r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 5],
                      r[:, 6]], -1)[:, None].expand(-1, n_cand + 1, 7)
    goal = torch.zeros_like(x0)
    goal[..., 3] = r[:, 4, None]
    curv = r[:, 7, None].expand(-1, n_cand + 1)
    with torch.no_grad():
        f = _smooth_cost(u_all, x0, goal, curv, p, cfg).cpu().numpy()
        xs = _rollout_rk4(x0, u_all.reshape(u_all.shape[:2] + (-1, 2)),
                          curv, p, cfg)
        v = torch.clamp(_state_box_violations(xs, cfg), min=0.0).amax(
            -1).cpu().numpy()
    f_star, v_star = f[:, 0], v[:, 0]
    f_cand, v_cand = f[:, 1:], v[:, 1:]
    improved = ((v_cand <= v_star[:, None] + 1e-6)
                & (f_cand < f_star[:, None] - 1e-6)).sum(1)
    if improved.any():
        raise RuntimeError(
            f"gold derivation found {improved.tolist()} improving "
            "perturbations per row: the solver's solution is NOT optimal")
    return dict(rows=np.asarray(rows, np.float64), u_star=u_star,
                f_star=f_star, v_star=v_star, cands=cands, f_cand=f_cand,
                v_cand=v_cand, seed=PERT_SEED, n_cand=n_cand)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", type=str, default=None,
                   help="where the perturbation gold's f64 solve runs "
                        "(default: the card); SLSQP runs on the host")
    p.add_argument("--out_dir", type=str,
                   default=os.path.join("torch_runs", "oracles"))
    p.add_argument("--n_rows", type=int, default=ORACLE_ROWS,
                   help="the fixture lattice's first n rows get the SLSQP "
                        "oracle (100: all of them)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    rows = nmpc_fixture_rows()[:args.n_rows]
    t0 = time.time()
    oracle = solve_oracle_rows(rows, fullscale_params(dtype=torch.float64,
                                                      device="cpu"),
                               NMPCConfig(), maxiter=300, ftol=1e-12)
    slsqp = os.path.join(args.out_dir, "nmpc_frenet_slsqp.npz")
    save_oracle(slsqp, rows, oracle, seed=ORACLE_SEED, maxiter=300,
                ftol=1e-12, mu=1.0, cs=5.0)
    print(f"{slsqp}: {rows.shape[0]} rows, "
          f"{int(oracle.feasible.sum())} oracle-feasible, "
          f"derived in {time.time() - t0:.1f}s")
    t0 = time.time()
    gold = derive_perturbation_gold(args.device)
    pert = os.path.join(args.out_dir, "nmpc_pert_gold.npz")
    np.savez_compressed(pert, **gold)
    print(f"{pert}: optimality proven for {len(gold['rows'])} rows x "
          f"{gold['n_cand']} perturbations")
    print(f"perturbation gold derived in {time.time() - t0:.1f}s")
    return {"slsqp": slsqp, "pert": pert}


if __name__ == "__main__":
    main()
