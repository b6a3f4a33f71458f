"""The goal-MPC lattice: every v_car family's goal block solved as the
table generator solves it, on one card (``solve_goal_lattice``) or split
over the ranks of a ``torch.distributed`` mesh
(``solve_goal_lattice_sharded``, one card a rank), the families in an order
drawn by the seed, repeated as long as the window lasts. The columns come
back to the host and are not written anywhere. The rate of solved goals is
reported under the traffic's ``rate_metric``: a mesh's rate is a metric of
its own, with its own bound.

``correct``: once the window has closed, the reference solves again, in
float64, rows drawn by the seed from every family the window finished, and
compares their speed, steer and converged columns (``judge``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, traffic
from benchmark.drivers import _common
from benchmark.harness import Outcome, forbidden_modules
from benchmark.reference import goal_qp
from benchmark.reference import precision as prec
from benchmark.trace import Spans, kernel_seconds, profile, summarize

# a converged flag is judged only where the reference's residuals lie this
# far from the tolerance: within it, float32 rounding decides the flag
FLAG_BAND = 2e-4


def problem(config: dict) -> goal_qp.Problem:
    q = config["qp"]
    return goal_qp.Problem(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in q.items()
                              if k in goal_qp.Problem._fields})


def program_config(config: dict):
    """The port's ``GoalMPCConfig`` from the configuration's QP."""
    from irbfn_tpu_torch.solvers.goal_mpc import GoalMPCConfig

    pb = problem(config)
    return GoalMPCConfig(
        horizon=pb.horizon, dt=pb.dt, wheelbase=pb.wheelbase,
        r_accel=pb.r_accel, r_steer=pb.r_steer, rd_accel=pb.rd_accel,
        rd_steer=pb.rd_steer, q_state=pb.q_state, qf_state=pb.qf_state,
        max_steer=pb.max_steer,
        max_dsteer=float(np.deg2rad(pb.max_dsteer_deg)),
        max_speed=pb.max_speed, min_speed=pb.min_speed,
        max_accel=pb.max_accel)


def rows_of_rank(G: int, bpd: int, world: int, rank: int) -> int:
    """Goal rows rank ``rank`` solves of a family of G in chunks of
    ``world * bpd`` (``solve_lattice_sharded``'s split; an empty block
    solves one row)."""
    n = 0
    for start in range(0, G, world * bpd):
        n += max(min(G - start - rank * bpd, bpd), 0) or 1
    return n


def run(cell) -> Outcome:
    world = int(cell.traffic["ranks"])
    if world == 1:
        return _outcome(cell, [_rank(cell)])
    from irbfn_tpu_torch.parallel.launch import spawn

    return _outcome(cell, spawn(_rank, world, cell.device, cell))


def _rank(cell) -> dict:
    """One rank's run: set-up, window, trace and, on rank 0, the check."""
    import torch.distributed as dist

    from irbfn_tpu_torch.solvers.goal_mpc import (solve_goal_lattice,
                                                  solve_goal_lattice_sharded)

    t = cell.traffic
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = torch.device(cell.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    prec.no_tf32()
    _common.reset_peak(device)
    cfg = program_config(cell.config)
    axes = goal_qp.lattice_axes(t["grid"])
    goals = goal_qp.goal_block(axes)
    G = goals.shape[0]
    vs = [float(v) for v in axes["v_car"].astype(np.float32)]
    order = traffic.family_order(len(vs), cell.seed)
    bpd = min(int(t["chunk"]), G)
    sweeps = int(t["sweeps"])
    if world > 1:
        from irbfn_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=device)

        def solve(v):
            return solve_goal_lattice_sharded(v, goals, cfg, iters=sweeps,
                                              mesh=mesh, batch_per_device=bpd,
                                              device=device)

        flag = torch.zeros(1, device=device)

        def stop(done: bool) -> bool:
            flag.fill_(float(done))
            dist.broadcast(flag, 0)
            return bool(flag.item())
    else:
        def solve(v):
            return solve_goal_lattice(v, goals, cfg, iters=sweeps,
                                      batch_per_device=bpd, device=device)

        def stop(done: bool) -> bool:
            return done

    solve(vs[order[0]])  # set-up: the kernel's build, buffers, handles
    if world > 1:
        dist.barrier()
    _common.sync(device)
    setup_s = time.time() - cell.t_start

    pick = traffic.rng(cell.seed, traffic.CHECK_SAMPLE)
    k_rows = min(int(t["check_rows_per_family"]), G)
    spans = Spans(cell.trace, device)
    samples, families = [], 0
    t0 = time.perf_counter()
    while True:
        v = vs[order[families % len(vs)]]
        with spans.span("bench.family"):
            out = solve(v)
        families += 1
        if rank == 0:
            idx = np.sort(pick.choice(G, k_rows, replace=False))
            samples.append((v, idx, out["speed"][idx].copy(),
                            out["steer"][idx].copy(),
                            out["converged"][idx].copy()))
        if stop(time.perf_counter() - t0 >= cell.seconds):
            break
    window = time.perf_counter() - t0

    res = dict(rank=rank, world=world, setup_s=setup_s, window=window,
               families=families, G=G, peak=0, summary=None,
               forbidden=forbidden_modules())
    if cell.trace:
        n_prof = int(t["profile_families"])
        with profile(device) as p:
            tp = _common.now(device)
            for i in range(n_prof):
                with torch.profiler.record_function("bench.family"):
                    solve(vs[order[i % len(vs)]])
            wall = _common.now(device) - tp
        res["summary"] = summarize(p, wall, n_prof)
        res["spans"] = dict(spans.times)
        res["rows_rank"] = rows_of_rank(G, bpd, world, rank)
    res["peak"] = _common.memory_peak(device)
    if rank == 0:
        del out
        _common.release(device)
        res["checks"] = judge(cell, samples, "program", device)
        if cell.control:
            res["control"] = judge(cell, samples, "control", device)
        res["kind"] = _common.device_kind(device)
    return res


def _outcome(cell, ranks: list) -> Outcome:
    r0 = ranks[0]
    world = r0["world"]
    solved = r0["families"] * r0["G"]
    layer, summary = {}, None
    if cell.trace:
        summary = dict(r0["summary"])
        summary["busy_s"] = float(np.mean([r["summary"]["busy_s"]
                                           for r in ranks]))
        sweeps = int(cell.traffic["sweeps"])
        n_prof = summary["units"]
        layer = dict(
            spans=r0["spans"], trace=summary, chips=world,
            family_flops=counts.lattice_family_flops(r0["G"], sweeps),
            admm_ops_bytes=(counts.admm_ops(r0["rows_rank"] * n_prof, sweeps),
                            counts.admm_bytes(r0["rows_rank"] * n_prof)),
            admm_kernel_s=kernel_seconds(r0["summary"], "admm"),
            nccl_kernel_s=kernel_seconds(r0["summary"], "ncclDevKernel",
                                         "ncclKernel"))
    checks = dict(r0["checks"])
    failed = checks.pop("failed")
    layer["forbidden_in_ranks"] = sorted({m for r in ranks
                                          for m in r["forbidden"]})
    if "control" in r0:
        layer["control"] = r0["control"]
    return Outcome(
        attempted=solved, failed=failed,
        end_to_end={cell.traffic["rate_metric"]: solved / r0["window"],
                    "setup_s": r0["setup_s"]},
        layer=layer, checks=checks,
        memory_peak_bytes=max(r["peak"] for r in ranks), trace=summary,
        device_kind=r0["kind"], device_count=world)


def judge(cell, samples: list, judged: str, device) -> dict:
    """The numbers that decide ``correct``, for the program's columns
    (``judged="program"``) or for the control's (``"control"``: the
    reference in TF32 in the program's place, on the same rows):
    ``speed_gap`` (m/s) and ``steer_gap`` (rad), the largest over rows that
    both sides call converged; ``flag_mismatch``, rows whose converged flags
    differ where the reference's residuals lie more than FLAG_BAND from the
    tolerance; and ``failed``, rows whose columns are not finite."""
    pb = problem(cell.config)
    tol = float(cell.config["qp"]["tol"])
    sweeps = int(cell.traffic["sweeps"])
    axes = goal_qp.lattice_axes(cell.traffic["grid"])
    goals = goal_qp.goal_block(axes)
    by_v = {}
    for v, idx, speed, steer, conv in samples:
        by_v.setdefault(v, []).append((idx, speed, steer, conv))
    speed_gap = steer_gap = 0.0
    mismatch = failed = 0
    for v, parts in by_v.items():
        idx = np.concatenate([p[0] for p in parts])
        ref = goal_qp.solve(v, goals[idx], pb, sweeps, "f64", device, tol)
        if judged == "control":
            got = goal_qp.solve(v, goals[idx], pb, sweeps, "tf32", device,
                                tol)
            speed, steer, conv = got["speed"], got["steer"], got["converged"]
        else:
            speed = np.concatenate([p[1] for p in parts])
            steer = np.concatenate([p[2] for p in parts])
            conv = np.concatenate([p[3] for p in parts])
        finite = np.isfinite(speed) & np.isfinite(steer)
        failed += int((~finite).sum())
        both = conv & ref["converged"]
        if both.any():
            speed_gap = max(speed_gap, float(np.nan_to_num(
                np.abs(speed - ref["speed"])[both], nan=np.inf).max()))
            steer_gap = max(steer_gap, float(np.nan_to_num(
                np.abs(steer - ref["steer"])[both], nan=np.inf).max()))
        clear = ((np.abs(ref["r_prim"] - tol) > FLAG_BAND)
                 & (np.abs(ref["r_dual"] - tol) > FLAG_BAND))
        mismatch += int(((conv != ref["converged"]) & clear).sum())
    return dict(speed_gap=speed_gap, steer_gap=steer_gap,
                flag_mismatch=mismatch, failed=failed)
