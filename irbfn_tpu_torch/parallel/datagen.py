"""Lattice data generation, on one device or across the data axis of a mesh.

Port of ``irbfn_tpu/parallel/datagen.py``: a grid spec becomes meshgrid
rows ('ij' order, so the table layout matches the reference's), and
``solve_lattice`` runs a batched solver over them in chunks on one device;
``solve_lattice_sharded`` splits every chunk over the ranks of the data axis
(``parallel/mesh.py``) and ``all_gather``s the results, so that every rank
returns the whole table. On the card, chunk i's results are copied back
into pinned host buffers while chunk i+1 is already queued, so the device
does not wait for those copies. ``controls_block`` flattens a table's
control sequences into the layout the nets are trained on.
``TableSolution`` is what a table keeps of an NMPC solution, and
``frenet_table`` assembles the on-disk table with its -999 sentinel rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from irbfn_tpu_torch._device import resolve_device

# chunks whose results may still be on their way to the host when the next
# chunk is queued
PIPELINE_DEPTH = 2


@dataclass(frozen=True)
class GridSpec:
    """One lattice axis: linspace(lo, hi, num), endpoint inclusive."""

    name: str
    lo: float
    hi: float
    num: int

    def values(self) -> np.ndarray:
        return np.linspace(self.lo, self.hi, self.num, endpoint=True)


# the reference's default frenet lattice
FRENET_GRID = (
    GridSpec("ey", -0.2, 2.0, 12),
    GridSpec("delta", -0.3, 0.3, 7),
    GridSpec("vx_car", 1.0, 7.0, 11),
    GridSpec("vy_car", -1.0, 1.0, 11),
    GridSpec("vx_goal", 3.0, 7.0, 5),
    GridSpec("wz", -2.6, 2.6, 11),
    GridSpec("epsi", -1.0, 1.0, 11),
    GridSpec("curv", -0.1, 0.1, 3),
)

# the reference's clothoid LUT lattice
CLOTHOID_GRID = (
    GridSpec("x", 5.0, 30.0, 251),
    GridSpec("y", -8.0, 8.0, 161),
    GridSpec("theta", -1.57, 1.57, 158),
)


def build_lattice(grid: Sequence[GridSpec], dtype=np.float32) -> np.ndarray:
    """Meshgrid the axes into flat rows (N, D), 'ij' indexing like the
    reference, so the row order (and the table layout) matches."""
    axes = [g.values() for g in grid]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(dtype)


def _to_host(t: torch.Tensor):
    """Start the copy of ``t`` into host memory; returns (buffer, event),
    the event None when ``t`` is already on the host."""
    if t.device.type == "cpu":
        return t, None
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return buf, event


class _HostPipeline:
    """The chunks' results on their way to the host: each dict of tensors
    is copied into pinned buffers as it is queued, and waited for only
    when more than ``PIPELINE_DEPTH`` are in flight, or at the end."""

    def __init__(self, progress_fn=None):
        self.outs, self.inflight = [], []
        self.progress_fn = progress_fn

    def put(self, result: dict, done: int):
        self.inflight.append(({k: _to_host(v) for k, v in result.items()},
                              done))
        if len(self.inflight) > PIPELINE_DEPTH:
            self._drain_one()

    def _drain_one(self):
        result, done = self.inflight.pop(0)
        for _, event in result.values():
            if event is not None:
                event.synchronize()
        self.outs.append({k: buf.numpy() for k, (buf, _) in result.items()})
        if self.progress_fn is not None:
            self.progress_fn(done)

    def result(self, name: str) -> dict:
        while self.inflight:
            self._drain_one()
        if not self.outs:
            raise ValueError(f"{name} needs at least one row")
        return {k: np.concatenate([o[k] for o in self.outs])
                for k in self.outs[0]}


def _to_device(rows: np.ndarray, device) -> torch.Tensor:
    chunk = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type == "cuda":
        return chunk.pin_memory().to(device, non_blocking=True)
    return chunk.to(device)


def solve_lattice(solve_fn: Callable, rows: np.ndarray,
                  batch_per_device: int = 65536, args=(),
                  device=None) -> dict:
    """Run ``solve_fn`` over a lattice in chunks on one device.

    Args:
        solve_fn: maps ``(B, D)`` row tensors (plus ``*args``) to a dict of
            ``(B, ...)`` tensors on the rows' device.
        rows: the full lattice ``(N, D)``, numpy.
        batch_per_device: rows per chunk; bounds the device memory of
            lattices of hundreds of millions of rows.
        args: extra operands passed through to ``solve_fn``.
        device: where the solve runs (None: the card).
    Returns:
        dict of numpy arrays with leading dim N.
    """
    device = resolve_device(device)
    pipe = _HostPipeline()
    for start in range(0, rows.shape[0], batch_per_device):
        chunk = _to_device(rows[start:start + batch_per_device], device)
        pipe.put(solve_fn(chunk, *args), start + chunk.shape[0])
    return pipe.result("solve_lattice")


def _gather_rows(t: torch.Tensor, sizes, group) -> torch.Tensor:
    """The data axis' blocks of one chunk, in rank order: rank j holds
    ``sizes[j]`` valid rows of ``t``. NCCL gathers equal sizes only, so
    every block goes padded to ``sizes[0]`` (the largest) and comes back
    trimmed; gloo gathers no bool, so bools travel as uint8."""
    n = sizes[0]
    if t.shape[0] < n:
        t = torch.cat([t, t[-1:].expand((n - t.shape[0],) + t.shape[1:])])
    send = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    blocks = [torch.empty_like(send) for _ in sizes]
    dist.all_gather(blocks, send, group=group)
    out = torch.cat([b[:m] for b, m in zip(blocks, sizes)])
    return out.to(torch.bool) if t.dtype == torch.bool else out


def solve_lattice_sharded(solve_fn: Callable, rows: np.ndarray, mesh=None,
                          batch_per_device: int = 65536,
                          progress: bool = False, args=(), device=None):
    """Run ``solve_fn`` over a lattice split across the mesh's data axis.

    The lattice goes in chunks of ``D * batch_per_device`` rows for D ranks
    on the data axis; data rank i solves rows ``[i*bpd, (i+1)*bpd)`` of each
    chunk (``P(DATA_AXIS)``; the ranks of one expert group solve the same
    rows), and the results are ``all_gather``ed over the data axis, so that
    every rank returns the whole table in row order (``out_shardings`` =
    replicated). Rank i's block of chunk c is block ``c*D + i`` of
    ``solve_lattice`` at the same ``batch_per_device``: the same rows go to
    the same solver, and at D = 1 the result is ``solve_lattice``'s bit for
    bit. A rank whose block of the last chunk is empty solves the last row
    alone and sends nothing of it.

    Args:
        solve_fn: maps ``(B, D)`` row tensors (plus ``*args``) to a dict of
            ``(B, ...)`` tensors, or one tensor, on the rows' device.
        rows: the full lattice ``(N, D)``, numpy, the same on every rank.
        mesh: a ``parallel.mesh.Mesh`` (None: ``make_mesh(expert=1)``, all
            ranks of the process group on the data axis, or a world of one).
        batch_per_device: rows per rank per chunk.
        progress: rank 0 prints rows done and the rate after each chunk.
        args: extra operands passed through to ``solve_fn``.
        device: where the solve runs (None: the mesh's device, or the card).
    Returns:
        dict of numpy arrays with leading dim N, or one array if
        ``solve_fn`` returns a tensor.
    """
    import time

    from irbfn_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    if mesh is None:
        mesh = make_mesh(expert=1, device=device)
    device = mesh.device if device is None else resolve_device(device)
    D, i = mesh.shape[DATA_AXIS], mesh.data_rank
    group = mesh.group(DATA_AXIS)
    n_total, bpd = rows.shape[0], int(batch_per_device)
    t0 = time.perf_counter()

    def report(done):
        rate = done / max(time.perf_counter() - t0, 1e-9)
        print(f"  lattice progress {done:,}/{n_total:,} ({rate:,.0f} rows/s)",
              flush=True)

    pipe = _HostPipeline(report if progress and mesh.rank == 0 else None)
    bare = False
    for start in range(0, n_total, D * bpd):
        sizes = [min(max(n_total - start - j * bpd, 0), bpd)
                 for j in range(D)]
        mine = rows[start + i * bpd:start + i * bpd + sizes[i]]
        result = solve_fn(_to_device(mine if sizes[i] else rows[-1:],
                                     device), *args)
        bare = torch.is_tensor(result)
        if bare:
            result = {"": result}
        if group is not None:
            result = {k: _gather_rows(v, sizes, group)
                      for k, v in result.items()}
        pipe.put(result, start + sum(sizes))
    out = pipe.result("solve_lattice_sharded")
    return out[""] if bare else out


class TableSolution(NamedTuple):
    """The table-relevant slice of an NMPCSolution: what datagen persists
    (``frenet_table`` below). Copying only this back to the host, with the
    activation one-hot as bool, cuts the per-row payload 4x against the
    full solution (the table format discards states and kkt anyway)."""

    accel: torch.Tensor  # (..., T)
    steer_vel: torch.Tensor  # (..., T)
    active_onehot: torch.Tensor  # (..., 86) bool
    feasible: torch.Tensor  # (...,) bool

    @classmethod
    def from_solution(cls, sol, include_onehot: bool = True) -> "TableSolution":
        """``include_onehot=False`` drops the 86-wide activation pattern
        (the dominant per-row payload) for tables that only feed lookup
        planners, e.g. multi-mu bandit banks, where constraint clustering
        is never run; ``frenet_table`` then omits ``constraints``."""
        onehot = (sol.active_onehot.to(torch.bool) if include_onehot
                  else sol.active_onehot[..., :0].to(torch.bool))
        return cls(sol.accel, sol.steer_vel, onehot, sol.feasible)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def frenet_table(rows, solution, n_constraints: int = 86) -> Dict[str, np.ndarray]:
    """Assemble the reference's on-disk table dict from an NMPCSolution or
    a TableSolution (tensors or numpy arrays): ``inputs`` (N, 8),
    ``outputs`` (N, T, 2) [accel, steer-vel columns], and ``constraints``
    (N, 86), with infeasible rows encoded as -999 sentinels, plus ``valid``.
    ``constraints`` is left out when the one-hot is empty."""
    accel = _host(solution.accel)
    sv = _host(solution.steer_vel)
    feas = _host(solution.feasible)
    onehot = _host(solution.active_onehot)
    outputs = np.stack([accel, sv], axis=-1)
    outputs[~feas] = -999.0
    table = {"inputs": _host(rows), "outputs": outputs, "valid": feas}
    if onehot.shape[-1]:
        constraints = onehot.astype(np.float64)
        constraints[~feas] = -999.0
        table["constraints"] = constraints
    return table


def save_table(path: str, table: Dict[str, np.ndarray]):
    np.savez(path, **table)


def controls_block(outputs: np.ndarray) -> np.ndarray:
    """Flatten a table's (N, T, 2) [accel, steer-vel] control sequences into
    the BLOCK layout ``[a_0..a_{T-1}, sv_0..sv_{T-1}]`` (N, 2T).

    This is the net-output and rollout layout: the trainers unpack
    ``outputs[:, :, 0]`` / ``[:, :, 1]`` and concatenate the blocks, and the
    dynamics adapters reshape controls column-major. A plain
    ``reshape(N, -1)`` on the npz INTERLEAVES [a0, sv0, a1, sv1, ...];
    consumed as block layout, that reads sv_2 where sv_0 belongs (a
    2-control-period steering delay in the planner). Rows of -999
    sentinels (infeasible solves) stay rows of -999. Already-flat (N, 2T)
    arrays pass through unchanged."""
    outputs = np.asarray(outputs)
    if outputs.ndim == 2:
        return outputs
    n, t, c = outputs.shape
    return outputs.transpose(0, 2, 1).reshape(n, c * t)
