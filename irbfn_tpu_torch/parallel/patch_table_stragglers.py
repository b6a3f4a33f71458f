"""Re-solve the flagged rows of a saved NMPC table and patch them in.

Port of ``scripts/patch_table_stragglers.py``, with its flags and prints plus
``--device`` and ``--dtype``. A table made without the straggler pass (or
with ``--resolve_factor 0``) has -999 holes where the f32 solver at the
tuned budget gave up on rows the problem admits. Instead of making the
whole lattice again, only the flagged rows are re-solved, at
``--resolve_factor`` times the iteration budget and two more AL rounds, and
``outputs``, ``constraints`` and ``valid`` are patched in place (the
table's own layout). A table of 7-wide inputs is a cartesian table
(``gen_nmpc_table_cartesian``): its rows are re-solved by the cartesian
solver with the F1TENTH-scale car, and its (N, 2T) outputs patched (the
JAX package's script reads Frenet tables only).

Under ``torchrun`` (``WORLD_SIZE`` set) every process is one rank of a
process group read from the environment, one card each: the flagged rows split
over the ranks (``datagen.py:solve_lattice_sharded``), every rank gathers
every re-solved row, and rank 0 alone prints and writes the table. Run alone it
is a world of one, the one-card run:
``torchrun --nproc_per_node N -m irbfn_tpu_torch.parallel.patch_table_stragglers ...``.

Usage: ``python -m irbfn_tpu_torch.parallel.patch_table_stragglers
--npz_path TABLE [--out PATCHED] [--resolve_factor 4] [--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params, fullscale_params
from irbfn_tpu_torch.parallel.datagen import (TableSolution,
                                              solve_lattice_sharded)
from irbfn_tpu_torch.parallel.launch import from_environment
from irbfn_tpu_torch.parallel.mesh import make_mesh
from irbfn_tpu_torch.solvers.nmpc import (NMPCConfig, cartesian_config,
                                          solve_cartesian_point,
                                          solve_lattice_point)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--out", type=str, default=None,
                   help="output path (default: overwrite input)")
    p.add_argument("--mu", type=float, default=1.0)
    p.add_argument("--cs", type=float, default=5.0)
    p.add_argument("--resolve_factor", type=int, default=4)
    p.add_argument("--batch_per_device", type=int, default=8192)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--device", type=str, default=None,
                   help="where the solves run (default: the card)")
    return p.parse_args(argv)


def patch(args, device=None, cfg: NMPCConfig = None) -> dict:
    """Re-solve and patch the table of ``args.npz_path`` (``cfg``: the
    table's budget, multiplied here; by default ``NMPCConfig()``, or
    ``cartesian_config()`` for a cartesian table). Returns the patched
    ``data`` dict, the flagged row indices ``bad``, the recovered mask
    ``recovered`` over them and the solve's ``seconds``; writes nothing."""
    device = resolve_device(args.device if device is None else device)
    with np.load(args.npz_path) as z:
        data = {k: z[k] for k in z.files}
    valid = data["valid"].astype(bool)
    bad = np.nonzero(~valid)[0]
    n = valid.size
    print(f"{n:,} rows, {bad.size:,} flagged infeasible "
          f"({100 * bad.size / n:.1f}%)")
    if not bad.size:
        print("nothing to patch")
        return dict(data=data, bad=bad, recovered=np.zeros(0, bool),
                    seconds=0.0)
    cartesian = data["inputs"].shape[1] == 7
    if cfg is None:
        cfg = cartesian_config() if cartesian else NMPCConfig()
    cfg_hard = dataclasses.replace(
        cfg, gn_iters=cfg.gn_iters * max(args.resolve_factor, 1),
        al_outer=cfg.al_outer + 2)
    keep_onehot = "constraints" in data
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    make_params = f1tenth_params if cartesian else fullscale_params
    params = make_params(mu=args.mu, cs=args.cs, dtype=dtype, device=device)

    def solve_hard(r):
        if cartesian:
            s = solve_cartesian_point(r, params, cfg_hard)
            return {"accel": s.accel, "steer_vel": s.steer_vel,
                    "feasible": s.feasible}
        return TableSolution.from_solution(
            solve_lattice_point(r, params, cfg_hard),
            include_onehot=keep_onehot)._asdict()

    rows = data["inputs"][bad].astype(np.float32 if args.dtype == "f32"
                                      else np.float64)
    t0 = wait_clock(device)
    sol = solve_lattice_sharded(solve_hard, rows,
                                mesh=make_mesh(device=device),
                                batch_per_device=args.batch_per_device)
    dt = wait_clock(device) - t0
    rec = sol["feasible"]
    print(f"re-solve ({args.resolve_factor}x budget): recovered "
          f"{int(rec.sum()):,}/{bad.size:,} in {dt:.0f}s "
          f"-> {100 * (valid.mean() + rec.sum() / n):.1f}% feasible")
    fixed = bad[rec]
    ctrl = (sol["accel"][rec], sol["steer_vel"][rec])
    out_ctrl = (np.concatenate(ctrl, axis=-1) if cartesian
                else np.stack(ctrl, axis=-1))
    data["outputs"][fixed] = out_ctrl.astype(data["outputs"].dtype)
    if keep_onehot:
        data["constraints"][fixed] = sol["active_onehot"][rec].astype(
            data["constraints"].dtype)
    data["valid"][fixed] = True
    return dict(data=data, bad=bad, recovered=rec, seconds=dt)


def main(argv=None) -> str:
    args = parse_args(argv)
    with from_environment(args.device) as rank:
        res = patch(args)
        if not res["bad"].size:
            return args.npz_path
        out = args.out or args.npz_path
        t0 = time.time()
        if rank == 0:
            np.savez(out, **res["data"])
        print(f"saved {out} in {time.time() - t0:.0f}s")
    return out


if __name__ == "__main__":
    main()
