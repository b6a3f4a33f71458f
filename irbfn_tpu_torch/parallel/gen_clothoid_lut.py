"""Clothoid G1-Hermite LUT generation on the cards.

Port of ``scripts/gen_clothoid_lut.py``, with the same flags, prints and npz,
plus ``--device`` and ``--batch_per_device``. The 3-D
(x, y, theta) goal lattice (by default 251 x 161 x 158 = 6,384,938 goals)
is solved by ``solvers/clothoid.py`` in chunks; each chunk is a few dozen
elementwise passes over a (rows, 48) quadrature-node axis.

Output npz (the reference's layout): ``lut`` (nx, ny, nt, 5) =
[k0, k1, k2, k3, s] and the axis arrays ``xlut``, ``ylut``, ``tlut``, as
``<save_path>/lut_allkappa<run_tag>.npz``.

Under ``torchrun`` (``WORLD_SIZE`` set) every process is one rank of a
process group read from the environment, one card each: the lattice splits
over the ranks (``datagen.py:solve_lattice_sharded``), every rank gathers
the whole table, and rank 0 alone prints and writes the files. Run alone it
is a world of one, the one-card run:
``torchrun --nproc_per_node N -m irbfn_tpu_torch.parallel.gen_clothoid_lut ...``.

Usage: ``python -m irbfn_tpu_torch.parallel.gen_clothoid_lut
[--save_path DIR] [--dx 0.1 --dy 0.1 --dt 0.02] [--device cuda]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.parallel.datagen import (GridSpec, build_lattice,
                                              solve_lattice_sharded)
from irbfn_tpu_torch.parallel.launch import from_environment
from irbfn_tpu_torch.parallel.mesh import make_mesh
from irbfn_tpu_torch.solvers.clothoid import solve_g1_hermite
from irbfn_tpu_torch.utils.args import add_clothoid_grid_args, add_io_args


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_clothoid_grid_args(p)
    add_io_args(p)
    p.add_argument("--batch_per_device", type=int, default=1 << 20,
                   help="goals per chunk (per rank)")
    p.add_argument("--device", type=str, default=None,
                   help="where the solves run (default: the card)")
    return p.parse_args(argv)


def grid_from_args(args) -> tuple:
    nx = int(round((args.maxx - args.minx) / args.dx)) + 1
    ny = int(round((args.maxy - args.miny) / args.dy)) + 1
    nt = int(round((args.maxt - args.mint) / args.dt)) + 1
    return (GridSpec("x", args.minx, args.maxx, nx),
            GridSpec("y", args.miny, args.maxy, ny),
            GridSpec("theta", args.mint, args.maxt, nt))


def _solve_chunk(goals: torch.Tensor) -> dict:
    sol = solve_g1_hermite(goals[:, 0], goals[:, 1], goals[:, 2])
    return {"params": sol.params, "converged": sol.converged}


def solve_table(args, device=None) -> dict:
    """Solve the lattice the flags describe. Returns ``grid``, ``goals``
    (N, 3), ``params`` (N, 5), ``converged`` (N,) (all numpy) and
    ``seconds`` (the solve, host copies included)."""
    device = resolve_device(args.device if device is None else device)
    grid = grid_from_args(args)
    goals = build_lattice(grid, dtype=np.float32)
    print(f"lattice: {goals.shape[0]:,} goals "
          f"({'x'.join(str(g.num) for g in grid)})", flush=True)
    t0 = wait_clock(device)
    out = solve_lattice_sharded(_solve_chunk, goals,
                                mesh=make_mesh(device=device),
                                batch_per_device=args.batch_per_device)
    dt = wait_clock(device) - t0
    print(f"solved in {dt:.2f}s -> {goals.shape[0] / dt:,.0f} solves/s",
          flush=True)
    return dict(grid=grid, goals=goals, seconds=dt, **out)


def lut_path(args) -> str:
    return os.path.join(args.save_path, f"lut_allkappa{args.run_tag}.npz")


def save_lut(path: str, grid, params: np.ndarray):
    nums = [g.num for g in grid]
    np.savez(path, lut=params.reshape(*nums, 5), xlut=grid[0].values(),
             ylut=grid[1].values(), tlut=grid[2].values())


def main(argv=None) -> str:
    args = parse_args(argv)
    with from_environment(args.device) as rank:
        res = solve_table(args)
        out = lut_path(args)
        if rank == 0:
            save_lut(out, res["grid"], res["params"])
        print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
