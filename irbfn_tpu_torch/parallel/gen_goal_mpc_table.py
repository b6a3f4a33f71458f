"""Goal-MPC table generation: the reference's goal lattice on the cards.

Port of ``scripts/gen_goal_mpc_table.py``, with the same flags, defaults and
npz. The lattice is a 5-D grid over v_car x x_goal x y_goal x t_goal x
v_goal, organised as (v_car family) x (goal block): every goal of a family
shares the condensed QP matrices and one KKT factorization, and each chunk
of a family is one launch of the ADMM kernel. The default grid is 19 v_car
families of 53 x 41 x 64 x 19 = 2,642,368 goals, 50,204,992 QPs.

Output npz (reference row layout): ``inputs`` (N, 5) = (v_car, x_goal,
y_goal, t_goal, v_goal), ``outputs`` (N, 2) = (speed, steer) with -999
where a row did not converge, ``valid`` = the convergence mask, plus the
grid metadata ``lows``, ``highs``, ``nums`` and ``dims``.

The run ends with what the lattice pipeline moved on this rank, from the
counters of ``utils/spans.py``: families, real rows, chunks, the bytes
staged through pinned memory and copied each way, and on a mesh the padding
rows, the bytes the gathers received and the short last chunks split evenly
over the ranks (``split_rounds``); then the families' operand builds,
and on a card the CUDA graph captures and replays that served them.

Under ``torchrun`` (``WORLD_SIZE`` set) every process is one rank of a
process group read from the environment, one card each: the lattice splits
over the ranks (``datagen.py:solve_lattice_sharded``), every rank gathers
the whole table, and rank 0 alone prints and writes the files. Run alone it
is a world of one, the one-card run:
``torchrun --nproc_per_node N -m irbfn_tpu_torch.parallel.gen_goal_mpc_table ...``.

Usage: ``python -m irbfn_tpu_torch.parallel.gen_goal_mpc_table
[--save_path DIR] [--iters 600] [--chunk 262144] [--device cuda]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from irbfn_tpu_torch.parallel.datagen import GridSpec, build_lattice
from irbfn_tpu_torch.parallel.launch import from_environment
from irbfn_tpu_torch.parallel.mesh import make_mesh
from irbfn_tpu_torch.solvers.goal_mpc import (GoalMPCConfig,
                                              solve_goal_lattice_sharded)
from irbfn_tpu_torch.utils import spans

DIMS = ("v_car", "x_goal", "y_goal", "t_goal", "v_goal")
# the reference grid, arange semantics (inclusive endpoint via +step, the
# reference's float-arange quirk)
DEFAULT_GRID = {"v_car": (-1.0, 8.0, 0.5), "x_goal": (-1.2, 4.0, 0.1),
                "y_goal": (0.0, 4.0, 0.1), "t_goal": (-3.14, 3.14, 0.1),
                "v_goal": (-1.0, 8.0, 0.5)}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, (lo, hi, step) in DEFAULT_GRID.items():
        p.add_argument(f"--{name}_min", type=float, default=lo)
        p.add_argument(f"--{name}_max", type=float, default=hi)
        p.add_argument(f"--d_{name}", type=float, default=step)
    p.add_argument("--save_path", type=str, default="./data")
    p.add_argument("--run_tag", type=str, default="")
    p.add_argument("--iters", type=int, default=600,
                   help="fixed ADMM sweeps")
    p.add_argument("--chunk", type=int, default=262144,
                   help="goals per kernel launch (per rank)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                   help="f64 runs the plain version: use it with --device "
                        "cpu (the kernel is f32)")
    p.add_argument("--device", type=str, default=None,
                   help="where the solves run (default: the card)")
    return p.parse_args(argv)


def grid_from_args(args) -> list:
    grid = []
    for d in DIMS:
        lo = getattr(args, f"{d}_min")
        hi = getattr(args, f"{d}_max")
        st = getattr(args, f"d_{d}")
        grid.append(GridSpec(d, lo, hi, int(round((hi - lo) / st)) + 1))
    return grid


def solve_table(args) -> dict:
    """Solve the lattice the flags describe. Returns the grid, the raw goal
    block (G, 4) in (x, y, t, v) order, the per-family columns speed,
    steer and valid (n_v, G), the seconds the solves took and what the
    pipeline moved (``spans.since`` of the ``lattice.`` counters)."""
    grid = grid_from_args(args)
    v_vals = grid[0].values()
    goals_raw = build_lattice(grid[1:], dtype=np.float32)  # (G, 4) x,y,t,v
    # solver goal ordering is (x, y, v, t), the state layout
    goals = goals_raw[:, [0, 1, 3, 2]].astype(
        np.float32 if args.dtype == "f32" else np.float64)
    G = goals.shape[0]
    n_total = G * len(v_vals)
    print(f"lattice: {len(v_vals)} v_car families x {G:,} goals = "
          f"{n_total:,} QPs", flush=True)
    cfg = GoalMPCConfig()
    mesh = make_mesh(device=args.device)
    speed = np.empty((len(v_vals), G), np.float32)
    steer = np.empty((len(v_vals), G), np.float32)
    valid = np.empty((len(v_vals), G), bool)
    before = spans.counters()
    t0 = time.perf_counter()
    for vi, v in enumerate(v_vals):
        v = float(np.asarray(v, goals.dtype))
        out = solve_goal_lattice_sharded(v, goals, cfg, iters=args.iters,
                                         mesh=mesh,
                                         batch_per_device=min(args.chunk, G))
        speed[vi] = out["speed"]
        steer[vi] = out["steer"]
        valid[vi] = out["converged"]
        done = (vi + 1) * G
        rate = done / (time.perf_counter() - t0)
        print(f"  family v_car={v:+.1f}: {done:,}/{n_total:,} "
              f"({rate:,.0f} QP solves/s)", flush=True)
    seconds = time.perf_counter() - t0
    print(f"{n_total / seconds:,.0f} QP solves/s overall; "
          f"{100 * valid.mean():.4f}% converged", flush=True)
    moved = spans.since(before, "lattice.")
    print("pipeline on this rank: " + ", ".join(
        f"{k[len('lattice.'):]} {v:,}" for k, v in moved.items()), flush=True)
    print("operands on this rank: " + ", ".join(
        f"{k[len('goal.'):]} {v:,}"
        for k, v in spans.since(before, "goal.").items()), flush=True)
    return dict(grid=grid, goals_raw=goals_raw, speed=speed, steer=steer,
                valid=valid, seconds=seconds, pipeline=moved)


def table_arrays(res: dict) -> dict:
    """The npz's arrays, in the reference row layout: v_car is the slowest
    axis (meshgrid 'ij' with v_car first)."""
    grid, goals_raw = res["grid"], res["goals_raw"]
    v_vals = grid[0].values()
    G = goals_raw.shape[0]
    inputs = np.concatenate(
        [np.repeat(v_vals, G).astype(np.float32)[:, None],
         np.tile(goals_raw, (len(v_vals), 1))], axis=1)
    outputs = np.stack([res["speed"].reshape(-1), res["steer"].reshape(-1)],
                       axis=1)
    vmask = res["valid"].reshape(-1)
    outputs[~vmask] = -999.0
    return dict(inputs=inputs, outputs=outputs, valid=vmask,
                lows=np.asarray([g.lo for g in grid], np.float32),
                highs=np.asarray([g.hi for g in grid], np.float32),
                nums=np.asarray([g.num for g in grid], np.int32),
                dims=np.asarray(DIMS))


def main(argv=None) -> str:
    args = parse_args(argv)
    with from_environment(args.device) as rank:
        res = solve_table(args)
        name = "x".join(str(g.num) for g in res["grid"])
        out = f"{args.save_path}/goal_mpc_table_{name}{args.run_tag}.npz"
        if rank == 0:
            np.savez_compressed(out, **table_arrays(res))
        print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
