"""NMPC-against-oracle agreement report: solve sampled Frenet lattice rows
with the batched AL/projected-Newton solver AND the independent scipy SLSQP
oracle (f64, on the host), and print the feasibility overlap and the
objective and control agreement percentiles.

Port of ``scripts/eval_nmpc_oracle.py``, with its flags and prints plus
``--device`` (where the batched solver runs; the oracle is host code).
``--flagged_study`` takes the rows that the table generator's f32 budget
flags infeasible and checks them against the oracle (the false-flag rate)
and against a ``--resolve_factor`` times budget re-solve (the recovery
rate): the -999 holes that the straggler pass fills.

Usage: ``python -m irbfn_tpu_torch.solvers.eval_nmpc_oracle
[--n_rows 200] [--flagged_study] [--json_out OUT] [--device cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import fullscale_params
from irbfn_tpu_torch.solvers.nmpc import NMPCConfig, solve_lattice_point
from irbfn_tpu_torch.solvers.oracle import compare_to_oracle, solve_oracle_rows


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_rows", type=int, default=200)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--maxiter", type=int, default=300)
    p.add_argument("--json_out", type=str, default=None)
    p.add_argument("--flagged_study", action="store_true",
                   help="false-infeasible study: the rows the f32-budget "
                        "solver flags, checked against the oracle and a "
                        "--resolve_factor x budget re-solve")
    p.add_argument("--resolve_factor", type=int, default=4)
    p.add_argument("--device", type=str, default=None,
                   help="where the batched solver runs (default: the card)")
    return p.parse_args(argv)


def sample_rows(n: int, seed: int) -> np.ndarray:
    """``n`` rows drawn uniformly from the reference Frenet ranges."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-0.2, 2.0, n), rng.uniform(-0.3, 0.3, n),
        rng.uniform(1.0, 7.0, n), rng.uniform(-1.0, 1.0, n),
        rng.uniform(3.0, 7.0, n), rng.uniform(-2.6, 2.6, n),
        rng.uniform(-1.0, 1.0, n), rng.uniform(-0.1, 0.1, n)])


def flagged_study(rows: np.ndarray, args, device,
                  cfg: NMPCConfig = NMPCConfig()) -> dict:
    """The false-flag and recovery rates of the rows the f32 solver flags
    at ``cfg``'s budget (empty dict when none is flagged)."""
    n = rows.shape[0]
    p32 = fullscale_params(dtype=torch.float32, device=device)
    sol32 = solve_lattice_point(torch.as_tensor(rows, dtype=torch.float32,
                                                device=device), p32, cfg)
    flagged = ~sol32.feasible.cpu().numpy()
    rows_f = rows[flagged]
    print(f"{flagged.sum()}/{n} rows flagged infeasible at the "
          f"f32 datagen budget ({cfg.gn_iters}/{cfg.al_outer})")
    if not flagged.any():
        return {}
    oracle = solve_oracle_rows(rows_f, fullscale_params(
        dtype=torch.float64, device="cpu"), cfg, maxiter=args.maxiter)
    false_flag = oracle.feasible  # oracle-solvable but flagged
    cfg_hard = dataclasses.replace(cfg,
                                   gn_iters=cfg.gn_iters * args.resolve_factor,
                                   al_outer=cfg.al_outer + 2)
    sol_hard = solve_lattice_point(
        torch.as_tensor(rows_f, dtype=torch.float32, device=device), p32,
        cfg_hard)
    rec = sol_hard.feasible.cpu().numpy()
    return {
        "n_rows": int(n),
        "flagged": int(flagged.sum()),
        "flagged_frac": float(flagged.mean()),
        "oracle_solvable_of_flagged": int(false_flag.sum()),
        "false_flag_rate_of_flagged": float(false_flag.mean()),
        "false_infeasible_frac_of_table": float(
            flagged.mean() * false_flag.mean()),
        "recovered_by_resolve": int(rec.sum()),
        "recovered_of_oracle_solvable": int((rec & false_flag).sum()),
        "residual_false_holes_frac": float(
            flagged.mean() * (false_flag & ~rec).mean()),
    }


def main(argv=None, cfg: NMPCConfig = NMPCConfig()) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rows = sample_rows(args.n_rows, args.seed)
    if args.flagged_study:
        m = flagged_study(rows, args, device, cfg)
    else:
        params = fullscale_params(dtype=torch.float64, device=device)
        m = compare_to_oracle(rows, params, cfg, maxiter=args.maxiter,
                              device=device)
        m = {k: v for k, v in m.items()
             if k not in ("al_only_rel_gap", "both_mask")}
    for k, v in m.items():
        print(f"{k}: {v}")
    if args.json_out and m:
        with open(args.json_out, "w") as f:
            json.dump(m, f, indent=1)
        print(f"saved {args.json_out}")
    return m


if __name__ == "__main__":
    main()
