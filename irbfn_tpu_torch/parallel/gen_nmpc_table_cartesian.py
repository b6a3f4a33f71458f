"""Cartesian NMPC table generation on the cards.

Port of ``scripts/gen_nmpc_table_cartesian.py``, with the same flags, prints
and npz, plus ``--device`` and ``--dtype``. The 7-D lattice
(v_car, x_goal, y_goal, t_goal, v_goal, beta, angv_z), given by ranges and
steps, is solved by the batched cartesian AL/Newton NMPC solver in chunks.

The solve is tiered as the Frenet generator's: a cheap first pass capped at
``--phase1_iters`` Newton iterations (the certificate does not depend on the
budget, so its certified rows are final), the full budget over the rows it
flags, then a straggler pass over what is still flagged at
``--resolve_factor`` times the iterations and two more AL rounds.

Output npz (reference layout): ``inputs`` (N, 7), ``outputs`` (N, 2T) =
[accel_0..accel_{T-1}, steer_vel_0..steer_vel_{T-1}] with -999 rows where a
solve is flagged, and ``valid``, as
``<save_path>/cart_table_<counts>_mu<mu>_cs<cs><run_tag>.npz``.

Under ``torchrun`` (``WORLD_SIZE`` set) every process is one rank of a
process group read from the environment, one card each: the lattice splits
over the ranks (``datagen.py:solve_lattice_sharded``), every rank gathers
the whole table, and rank 0 alone prints and writes the files. Run alone it
is a world of one, the one-card run:
``torchrun --nproc_per_node N -m irbfn_tpu_torch.parallel.gen_nmpc_table_cartesian ...``.

Usage: ``python -m irbfn_tpu_torch.parallel.gen_nmpc_table_cartesian
[--d_x_goal 0.5 ...] [--save_path DIR] [--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.parallel.datagen import (GridSpec, build_lattice,
                                              save_table,
                                              solve_lattice_sharded)
from irbfn_tpu_torch.parallel.launch import from_environment
from irbfn_tpu_torch.parallel.mesh import make_mesh
from irbfn_tpu_torch.solvers.nmpc import (NMPCConfig, cartesian_config,
                                          solve_cartesian_point)
from irbfn_tpu_torch.utils.args import add_io_args, add_vehicle_args

DIMS = ("v_car", "x_goal", "y_goal", "t_goal", "v_goal", "beta", "angv_z")
# (lo, hi, step) of each axis: the reference's step-based defaults
DEFAULT_GRID = {"v_car": (0.0, 7.0, 1.0), "x_goal": (0.0, 3.5, 0.2),
                "y_goal": (0.0, 3.5, 0.2), "t_goal": (-3.1, 3.1, 0.1),
                "v_goal": (0.0, 7.0, 1.0), "beta": (-0.6, 0.6, 0.2),
                "angv_z": (-3.0, 3.0, 0.5)}
# the cart_c1 table of docs/ARTIFACTS.md: 8x8x8x17x8x5x7 = 2,437,120 rows
C1_ARGS = ("--d_x_goal", "0.5", "--d_y_goal", "0.5", "--d_t_goal", "0.4",
           "--d_beta", "0.3", "--d_angv_z", "1.0", "--run_tag", "_c1")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, (lo, hi, step) in DEFAULT_GRID.items():
        p.add_argument(f"--{name}_min", type=float, default=lo)
        p.add_argument(f"--{name}_max", type=float, default=hi)
        p.add_argument(f"--d_{name}", type=float, default=step)
    add_vehicle_args(p)
    add_io_args(p)
    p.add_argument("--batch_per_device", type=int, default=8192)
    p.add_argument("--phase1_iters", type=int, default=12,
                   help="Newton cap for the cheap first pass of the tiered "
                        "solve (0 = flat). The feasibility certificate is "
                        "budget-independent, so cheap-pass-certified rows "
                        "are final and only flagged rows pay the full "
                        "budget")
    p.add_argument("--resolve_factor", type=int, default=4,
                   help="iteration-budget multiplier for the straggler "
                        "re-solve over still-flagged rows (0 disables)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--device", type=str, default=None,
                   help="where the solves run (default: the card)")
    return p.parse_args(argv)


def grid_from_args(args) -> tuple:
    grid = []
    for d in DIMS:
        lo, hi = getattr(args, f"{d}_min"), getattr(args, f"{d}_max")
        num = int(round((hi - lo) / getattr(args, f"d_{d}"))) + 1
        grid.append(GridSpec(d, lo, hi, num))
    return tuple(grid)


def table_name(args, grid) -> str:
    name = "x".join(str(g.num) for g in grid)
    return (f"{args.save_path}/cart_table_{name}_mu{args.mu}_cs{args.cs}"
            f"{args.run_tag}.npz")


class TableFields:
    """Host-side copy of what the table keeps of a solution."""

    def __init__(self, out: dict):
        self.accel = out["accel"]
        self.steer_vel = out["steer_vel"]
        self.feasible = out["feasible"]


def solve_table(args, device=None, cfg: NMPCConfig = None) -> dict:
    """Solve the lattice the flags describe (``cfg``: the full budget, by
    default ``cartesian_config()``). Returns ``mu``, ``grid``, ``rows``,
    ``sol`` (a ``TableFields`` of numpy arrays), ``certified_cheap`` (None
    when the solve was flat), ``touched`` (rows a later pass re-solved),
    ``feasible_tiered``, ``seconds`` and ``rates`` per pass, as the Frenet
    generator's ``solve_table`` returns for each mu."""
    device = resolve_device(args.device if device is None else device)
    cfg = cartesian_config() if cfg is None else cfg
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    grid = grid_from_args(args)
    rows = build_lattice(grid, dtype=np.float32 if args.dtype == "f32"
                         else np.float64)
    n = rows.shape[0]
    print(f"lattice: {n:,} NMPC problems", flush=True)
    params = f1tenth_params(mu=args.mu, cs=args.cs, dtype=dtype,
                            device=device)

    def solver(c):
        def fn(r):
            s = solve_cartesian_point(r, params, c)
            return {"accel": s.accel, "steer_vel": s.steer_vel,
                    "feasible": s.feasible}
        return fn

    mesh = make_mesh(device=device)

    def run(c, r):
        t0 = wait_clock(device)
        out = solve_lattice_sharded(solver(c), r, mesh=mesh,
                                    batch_per_device=args.batch_per_device)
        return TableFields(out), wait_clock(device) - t0

    touched = np.zeros(n, bool)

    def resolve_flagged(sol, c, tag):
        bad = np.nonzero(~sol.feasible)[0]
        if not bad.size:
            return sol, 0.0
        s2, dt = run(c, rows[bad])
        touched[bad] = True
        sol.accel[bad] = s2.accel
        sol.steer_vel[bad] = s2.steer_vel
        sol.feasible[bad] = s2.feasible
        print(f"  {tag}: recovered {int(s2.feasible.sum()):,}/{bad.size:,} "
              f"flagged rows in {dt:.0f}s -> "
              f"{100 * float(sol.feasible.mean()):.1f}% feasible",
              flush=True)
        return sol, dt

    seconds, certified = {}, None
    if args.phase1_iters > 0:
        sol, seconds["cheap"] = run(
            dataclasses.replace(cfg, gn_iters=args.phase1_iters), rows)
        certified = float(sol.feasible.mean())
        print(f"cheap pass ({args.phase1_iters}-cap) certified "
              f"{100 * certified:.1f}%", flush=True)
        sol, seconds["full"] = resolve_flagged(sol, cfg,
                                               "full-budget re-solve")
    else:
        sol, seconds["full"] = run(cfg, rows)
    dt = sum(seconds.values())
    feas_tiered = float(sol.feasible.mean())
    print(f"{n / dt:,.0f} solves/s, {100 * feas_tiered:.1f}% feasible",
          flush=True)
    n_hard = int((~sol.feasible).sum())
    if args.resolve_factor > 0:
        cfg_hard = dataclasses.replace(
            cfg, gn_iters=cfg.gn_iters * max(args.resolve_factor, 1),
            al_outer=cfg.al_outer + 2)
        sol, seconds["straggler"] = resolve_flagged(
            sol, cfg_hard,
            f"straggler re-solve ({args.resolve_factor}x budget)")
    total = sum(seconds.values())
    rates = {"tiered": n / dt, "overall": n / total}
    if seconds.get("straggler", 0.0) > 0:
        rates["straggler"] = n_hard / seconds["straggler"]
    return dict(mu=float(args.mu), grid=grid, rows=rows, sol=sol,
                certified_cheap=certified, touched=touched,
                feasible_tiered=feas_tiered, seconds=seconds, rates=rates)


def cartesian_table(rows: np.ndarray, sol) -> dict:
    """The on-disk table: ``inputs``, ``outputs`` (N, 2T) with -999 rows
    where ``sol`` is flagged, ``valid``."""
    outputs = np.concatenate([np.asarray(sol.accel),
                              np.asarray(sol.steer_vel)], axis=-1)
    valid = np.asarray(sol.feasible).astype(bool)
    outputs[~valid] = -999.0
    return {"inputs": rows, "outputs": outputs, "valid": valid}


def main(argv=None) -> str:
    args = parse_args(argv)
    with from_environment(args.device) as rank:
        res = solve_table(args)
        out = table_name(args, res["grid"])
        if rank == 0:
            save_table(out, cartesian_table(res["rows"], res["sol"]))
        print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
