"""Lattice data generation on one device.

Port of the one-device part of ``irbfn_tpu/parallel/datagen.py``: a grid
spec becomes meshgrid rows ('ij' order, so the table layout matches the
reference's), and ``solve_lattice`` runs a batched solver over them in
chunks. On the card, chunk i's results are copied back into pinned host
buffers while chunk i+1 is already queued, so the device does not wait for
those copies. Sharding across cards, ``TableSolution``, ``frenet_table`` and
``controls_block`` are still to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

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
    outs, inflight = [], []

    def drain_one():
        result = inflight.pop(0)
        for _, event in result.values():
            if event is not None:
                event.synchronize()
        outs.append({k: buf.numpy() for k, (buf, _) in result.items()})

    for start in range(0, rows.shape[0], batch_per_device):
        chunk = torch.from_numpy(np.ascontiguousarray(
            rows[start:start + batch_per_device]))
        if device.type == "cuda":
            chunk = chunk.pin_memory().to(device, non_blocking=True)
        else:
            chunk = chunk.to(device)
        result = solve_fn(chunk, *args)
        inflight.append({k: _to_host(v) for k, v in result.items()})
        if len(inflight) > PIPELINE_DEPTH:
            drain_one()
    while inflight:
        drain_one()
    if not outs:
        raise ValueError("solve_lattice needs at least one row")
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
