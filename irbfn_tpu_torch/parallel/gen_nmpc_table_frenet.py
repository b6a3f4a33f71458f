"""Frenet NMPC table generation on the cards.

Port of ``scripts/gen_nmpc_table_frenet.py``, with the same flags, prints
and npz file name, plus ``--device`` and ``--dtype``. The 8-D state lattice
is solved by the batched AL/Newton NMPC solver in chunks; the outer mu sweep
reuses everything but the vehicle parameters. Output npz (reference layout):
``inputs`` (N, 8), ``outputs`` (N, T, 2), ``constraints`` (N, 86) with -999
sentinel rows for infeasible points, plus ``valid``.

The solve is tiered. A cheap first pass caps the Newton iterations at
``--phase1_iters``: a batched solve runs until its slowest row is done, so
the cap is the cost, while the feasibility certificate (KKT residual and
constraint violation under their tolerances) does not depend on the budget.
Rows the cheap pass certifies are final; only the flagged rows pay the full
budget, and what that pass still flags is re-solved once more with
``--resolve_factor`` times the iterations and two more AL rounds.

Under ``torchrun`` (``WORLD_SIZE`` set) every process is one rank of a
process group read from the environment, one card each: the lattice splits
over the ranks (``datagen.py:solve_lattice_sharded``), every rank gathers
the whole table, and rank 0 alone prints and writes the files. Run alone it
is a world of one, the one-card run:
``torchrun --nproc_per_node N -m irbfn_tpu_torch.parallel.gen_nmpc_table_frenet ...``.

Usage: ``python -m irbfn_tpu_torch.parallel.gen_nmpc_table_frenet
[--save_path DIR] [--batch_per_device 8192] [--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import fullscale_params
from irbfn_tpu_torch.parallel.datagen import (GridSpec, TableSolution,
                                              build_lattice, frenet_table,
                                              save_table,
                                              solve_lattice_sharded)
from irbfn_tpu_torch.parallel.launch import from_environment
from irbfn_tpu_torch.parallel.mesh import make_mesh
from irbfn_tpu_torch.solvers.nmpc import NMPCConfig, solve_lattice_point
from irbfn_tpu_torch.utils.args import (add_frenet_grid_args, add_io_args,
                                        add_vehicle_args)

DIMS = ("ey", "delta", "vx_car", "vy_car", "vx_goal", "wz", "epsi", "curv")
# the flagship "wide" table's flags over the defaults (docs/ARTIFACTS.md);
# its per-axis counts are 12 x 7 x 11 x 5 x 6 x 7 x 7 x 9 = 12.2M rows
WIDE_RANGE_ARGS = ("--vx_car_max", "8", "--vx_goal_max", "8", "--curv_min",
                   "-0.45", "--curv_max", "0.45")


def wide_rows(n: int, seed: int, dtype=np.float32) -> np.ndarray:
    """``n`` rows drawn uniformly, by seed, from the wide table's ranges."""
    grid = grid_from_args(parse_args(list(WIDE_RANGE_ARGS)))
    rng = np.random.default_rng(seed)
    return rng.uniform([g.lo for g in grid], [g.hi for g in grid],
                       (n, len(grid))).astype(dtype)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_frenet_grid_args(p)
    add_vehicle_args(p)
    add_io_args(p)
    p.add_argument("--batch_per_device", type=int, default=8192)
    p.add_argument("--resolve_factor", type=int, default=4,
                   help="iteration-budget multiplier for the straggler "
                        "re-solve pass over rows the tiered solve flags "
                        "infeasible (0 disables). The f32 solver at the "
                        "tuned budget is conservative: a slice of flagged "
                        "rows are oracle-solvable stragglers, and re-solving "
                        "only them harder fills false table holes")
    p.add_argument("--phase1_iters", type=int, default=12,
                   help="Newton-iteration cap for the cheap first pass of "
                        "the tiered solve (0 = flat full-budget solve). "
                        "The feasibility certificate (KKT + violation "
                        "tolerances) is budget-independent, so rows "
                        "certified by the cheap pass are final and only "
                        "flagged rows pay the full budget")
    p.add_argument("--skip_constraints", action="store_true",
                   help="omit the 86-wide activation one-hot from the copy "
                        "back and the npz: lookup-planner banks (multi-mu "
                        "bandit arms) never run constraint clustering, and "
                        "the one-hot dominates the per-row bytes")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--device", type=str, default=None,
                   help="where the solves run (default: the card)")
    return p.parse_args(argv)


def grid_from_args(args) -> tuple:
    return tuple(
        GridSpec(d, getattr(args, f"{d}_min"), getattr(args, f"{d}_max"),
                 getattr(args, f"num_{d}")) for d in DIMS)


def table_name(args, grid, mu: float) -> str:
    name = "x".join(str(g.num) for g in grid)
    return (f"{args.save_path}/frenet_table_{name}_mu{mu:.2f}_"
            f"cs{args.cs}{args.run_tag}.npz")


def solve_table(args, device=None, cfg: NMPCConfig = NMPCConfig()) -> list:
    """Solve the lattice the flags describe, once per mu of the sweep.

    Returns one dict per mu (in the order solved, the largest mu first):
    ``mu``, ``grid``, ``rows`` (N, 8), ``sol`` (a host-side TableSolution of
    numpy arrays), ``certified_cheap`` (share of rows the cheap pass
    certified, None when the solve was flat), ``touched`` (bool (N,): rows
    some later pass re-solved), ``seconds`` (per pass) and ``rates``
    (solves/s per pass, ``tiered`` = N over the cheap and full passes,
    ``overall`` = N over everything)."""
    device = resolve_device(args.device if device is None else device)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    grid = grid_from_args(args)
    rows = build_lattice(grid, dtype=np.float32 if args.dtype == "f32"
                         else np.float64)
    n = rows.shape[0]
    print(f"lattice: {n:,} NMPC problems", flush=True)

    mus = ([args.mu] if args.mu_min is None else
           list(np.arange(args.mu_min, args.mu_max + args.d_mu, args.d_mu)))
    keep_onehot = not args.skip_constraints

    def solver(c):
        def fn(r, pv):
            return TableSolution.from_solution(
                solve_lattice_point(r, pv, c),
                include_onehot=keep_onehot)._asdict()
        return fn

    solve = solver(cfg)
    # tiered cheap first pass (see --phase1_iters)
    solve_p1 = (solver(dataclasses.replace(cfg, gn_iters=args.phase1_iters))
                if args.phase1_iters > 0 else None)
    # straggler pass: same problem, bigger iteration budget
    solve_hard = solver(dataclasses.replace(
        cfg, gn_iters=cfg.gn_iters * max(args.resolve_factor, 1),
        al_outer=cfg.al_outer + 2))

    mesh = make_mesh(device=device)

    def run(fn, r, params):
        t0 = wait_clock(device)
        out = solve_lattice_sharded(fn, r, mesh=mesh,
                                    batch_per_device=args.batch_per_device,
                                    args=(params,))
        return TableSolution(**out), wait_clock(device) - t0

    def resolve_flagged(sol, fn, params, tag, touched):
        """Re-solve the rows ``sol`` flags infeasible with ``fn`` and merge
        (the certificate is budget-independent, so certified rows are
        final). Returns the merged solution and the pass's seconds."""
        bad = np.nonzero(~sol.feasible)[0]
        if not bad.size:
            return sol, 0.0
        sol2, dt = run(fn, rows[bad], params)
        touched[bad] = True
        sol.accel[bad] = sol2.accel
        sol.steer_vel[bad] = sol2.steer_vel
        sol.active_onehot[bad] = sol2.active_onehot
        sol.feasible[bad] = sol2.feasible
        print(f"  {tag}: recovered {int(sol2.feasible.sum()):,}/{bad.size:,} "
              f"flagged rows in {dt:.0f}s -> "
              f"{100 * float(sol.feasible.mean()):.1f}% feasible",
              flush=True)
        return sol, dt

    results = []
    for mu in mus[::-1]:
        params = fullscale_params(mu=float(mu), cs=args.cs, dtype=dtype,
                                  device=device)
        seconds, certified = {}, None
        touched = np.zeros(n, bool)
        if solve_p1 is not None:
            sol, seconds["cheap"] = run(solve_p1, rows, params)
            certified = float(sol.feasible.mean())
            print(f"mu={mu:.2f}: cheap pass ({args.phase1_iters}-cap) "
                  f"certified {100 * certified:.1f}%", flush=True)
            sol, seconds["full"] = resolve_flagged(
                sol, solve, params, "full-budget re-solve", touched)
        else:
            sol, seconds["full"] = run(solve, rows, params)
        dt = sum(seconds.values())
        feas_tiered = float(sol.feasible.mean())
        print(f"mu={mu:.2f}: {n / dt:,.0f} solves/s, "
              f"{100 * feas_tiered:.1f}% feasible", flush=True)
        n_hard = int((~sol.feasible).sum())
        if args.resolve_factor > 0:
            sol, seconds["straggler"] = resolve_flagged(
                sol, solve_hard, params,
                f"straggler re-solve ({args.resolve_factor}x budget)",
                touched)
        total = sum(seconds.values())
        rates = {"tiered": n / dt, "overall": n / total}
        if "cheap" in seconds:
            rates["cheap"] = n / seconds["cheap"]
            n_full = int(round((1.0 - certified) * n))
            if n_full and seconds["full"] > 0:
                rates["full"] = n_full / seconds["full"]
        elif seconds["full"] > 0:
            rates["full"] = n / seconds["full"]
        if seconds.get("straggler", 0.0) > 0:
            rates["straggler"] = n_hard / seconds["straggler"]
        results.append(dict(mu=float(mu), grid=grid, rows=rows, sol=sol,
                            certified_cheap=certified, touched=touched,
                            feasible_tiered=feas_tiered, seconds=seconds,
                            rates=rates))
    return results


def main(argv=None) -> list:
    args = parse_args(argv)
    outs = []
    with from_environment(args.device) as rank:
        for res in solve_table(args):
            out = table_name(args, res["grid"], res["mu"])
            if rank == 0:
                save_table(out, frenet_table(res["rows"], res["sol"]))
            print(f"saved {out}")
            outs.append(out)
    return outs


if __name__ == "__main__":
    main()
