"""Lattice data generation, on one device or across the data axis of a mesh.

Port of ``irbfn_tpu/parallel/datagen.py``: a grid spec becomes meshgrid
rows ('ij' order, so the table layout matches the reference's), and
``solve_lattice`` runs a batched solver over them in chunks on one device;
``solve_lattice_sharded`` splits every chunk over the ranks of the data axis
(``parallel/mesh.py``) and ``all_gather``s the results, so that every rank
returns the whole table. A call's host work is done once, not once a
chunk: the first chunk's result allocates the table's columns (pinned on
the card), and each chunk's results are copied into their rows while the
next chunk is already queued, so the device waits neither for those copies
nor for a concatenation; the chunks' rows reach the card through pinned
staging buffers that every call reuses. Each family call, and each chunk's
staging, solve, gather, copy back and drain, is a span of
``utils/spans.py`` (``lattice.*``), with its rows and bytes counted there.
``controls_block`` flattens a table's control sequences into the layout the
nets are trained on.
``TableSolution`` is what a table keeps of an NMPC solution, and
``frenet_table`` assembles the on-disk table with its -999 sentinel rows.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.utils import spans

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


class _HostPipeline:
    """The chunks' results on their way into the lattice's host columns.

    The first chunk's result allocates one column a key, ``n`` rows in
    front of the chunk's trailing shape and dtype, pinned when the result
    is on the card; the columns are new on every call, since the caller
    keeps them. Each chunk's rows are copied into their slice as they are
    queued, and waited for only when more than ``PIPELINE_DEPTH`` chunks
    are in flight, or at the end."""

    def __init__(self, n: int, progress_fn=None):
        self.n, self.cols, self.inflight = n, None, []
        self.progress_fn = progress_fn

    def _columns(self, result: dict) -> dict:
        cols = {}
        for k, v in result.items():
            first = v[0] if isinstance(v, list) else v
            cols[k] = torch.empty((self.n,) + first.shape[1:],
                                  dtype=first.dtype, pin_memory=first.is_cuda)
            if first.is_cuda:
                spans.count("lattice.pinned_bytes",
                            cols[k].numel() * cols[k].element_size())
        return cols

    def put(self, result: dict, start: int, done: int, chunk: int):
        """Copy ``result`` into the columns' rows from ``start`` on: each
        key's value is the chunk's rows as one tensor, or as a list of
        blocks laid end to end."""
        with spans.span("lattice.put", chunk):
            if self.cols is None:
                self.cols = self._columns(result)
            nbytes, on_card = 0, False
            for k, v in result.items():
                row = start
                for block in (v if isinstance(v, list) else [v]):
                    m = block.shape[0]
                    if m:
                        self.cols[k][row:row + m].copy_(block,
                                                        non_blocking=True)
                        nbytes += block.numel() * block.element_size()
                        on_card |= block.is_cuda
                    row += m
            event = None
            if on_card:
                spans.count("lattice.d2h_bytes", nbytes)
                event = torch.cuda.Event()
                event.record()
            self.inflight.append((event, done, chunk))
        if len(self.inflight) > PIPELINE_DEPTH:
            self._drain_one()

    def _drain_one(self):
        event, done, chunk = self.inflight.pop(0)
        with spans.span("lattice.drain", chunk):
            if event is not None:
                event.synchronize()
        if self.progress_fn is not None:
            self.progress_fn(done)

    def result(self, name: str) -> dict:
        with spans.span("lattice.assemble"):
            while self.inflight:
                self._drain_one()
            if self.cols is None:
                raise ValueError(f"{name} needs at least one row")
            return {k: c.numpy() for k, c in self.cols.items()}


# pinned staging buffers of the chunks' rows, kept across calls:
# {(shape, dtype): [[buffer, event of the H2D copy that last read it], ...]},
# used in turn
_STAGING: dict = {}


def _staging_slot(shape: tuple, dtype) -> list:
    """The next of ``PIPELINE_DEPTH + 1`` pinned buffers of ``shape`` and
    ``dtype``, once the copy that last read it is done: with at most
    ``PIPELINE_DEPTH`` chunks in flight, that copy has long finished."""
    ring = _STAGING.setdefault((shape, dtype), collections.deque())
    if len(ring) <= PIPELINE_DEPTH:
        slot = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
        spans.count("lattice.pinned_bytes",
                    slot[0].numel() * slot[0].element_size())
    else:
        slot = ring.popleft()
        if slot[1] is not None:
            slot[1].synchronize()
    ring.append(slot)
    return slot


def _to_device(rows: np.ndarray, device, chunk: int, real: int,
               capacity: int) -> torch.Tensor:
    """Chunk ``chunk``'s rows on ``device``, through a pinned staging
    buffer of ``capacity`` rows on the card; ``real`` of them are the
    lattice's (the rest stand in for an empty block)."""
    with spans.span("lattice.stage", chunk):
        spans.count("lattice.rows", real)
        t = torch.from_numpy(np.ascontiguousarray(rows))
        if device.type != "cuda":
            return t.to(device)
        spans.count("lattice.h2d_bytes", t.numel() * t.element_size())
        slot = _staging_slot((capacity,) + t.shape[1:], t.dtype)
        staged = slot[0][:t.shape[0]]
        # one thread: torch's parallel copy waits for its slowest worker,
        # and on a host whose cores are shared a descheduled worker now
        # and then costs a scheduler tick (~5 ms), here on the path of the
        # family's first chunk while the card has nothing queued
        np.copyto(staged.numpy(), rows)
        out = staged.to(device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out


def _solve_chunk(solve_fn, rows: torch.Tensor, args, chunk: int):
    with spans.span("lattice.solve", chunk):
        spans.count("lattice.chunks")
        return solve_fn(rows, *args)


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
    n = rows.shape[0]
    capacity = min(batch_per_device, n)
    with spans.span(spans.FAMILY):
        spans.count("lattice.families")
        pipe = _HostPipeline(n)
        for c, start in enumerate(range(0, n, batch_per_device)):
            part = rows[start:start + batch_per_device]
            chunk = _to_device(part, device, c, part.shape[0], capacity)
            pipe.put(_solve_chunk(solve_fn, chunk, args, c), start,
                     start + part.shape[0], c)
        return pipe.result("solve_lattice")


def _gather_rows(t: torch.Tensor, sizes, group) -> list:
    """The data axis' blocks of one chunk, in rank order: rank j holds
    ``sizes[j]`` valid rows of ``t``. NCCL gathers equal sizes only, so
    every block goes padded to ``sizes[0]`` (the largest) and comes back
    trimmed, each block left where it landed for the host pipeline to copy
    into its rows; gloo gathers no bool, so bools travel as uint8."""
    n = sizes[0]
    if t.shape[0] < n:
        t = torch.cat([t, t[-1:].expand((n - t.shape[0],) + t.shape[1:])])
    send = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    blocks = [torch.empty_like(send) for _ in sizes]
    spans.count("lattice.gather_bytes",
                len(sizes) * send.numel() * send.element_size())
    dist.all_gather(blocks, send, group=group)
    return [b[:m].to(t.dtype) for b, m in zip(blocks, sizes)]


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

    capacity = min(bpd, n_total)
    with spans.span(spans.FAMILY):
        spans.count("lattice.families")
        pipe = _HostPipeline(
            n_total, report if progress and mesh.rank == 0 else None)
        bare = False
        for c, start in enumerate(range(0, n_total, D * bpd)):
            sizes = [min(max(n_total - start - j * bpd, 0), bpd)
                     for j in range(D)]
            mine = rows[start + i * bpd:start + i * bpd + sizes[i]]
            result = _solve_chunk(solve_fn, _to_device(
                mine if sizes[i] else rows[-1:], device, c, sizes[i],
                capacity), args, c)
            bare = torch.is_tensor(result)
            if bare:
                result = {"": result}
            if group is not None:
                with spans.span("lattice.gather", c):
                    # the rows this rank sends that are not its own: the
                    # padding to the largest block (and an empty block's
                    # stand-in row)
                    spans.count("lattice.pad_rows", sizes[0] - sizes[i])
                    result = {k: _gather_rows(v, sizes, group)
                              for k, v in result.items()}
            pipe.put(result, start, start + sum(sizes), c)
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
