"""Explicit (lookup-table) planners: plan by querying the raw solver table.

Port of ``irbfn_tpu/planning/explicit.py``:

- lookups are **grid-index arithmetic**: the tables ARE regular lattices, so
  the nearest row is round((q - lo) / step) per dimension, batched over
  queries, with no search;
- a brute-force nearest-neighbor path covers irregular (filtered) tables:
  distance argmin via one (B, N) matrix product;
- infeasible (-999) rows are guarded by a validity mask instead of runtime
  value checks.

Tables live on a device (``device=None``: the card) and queries are looked
up there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.parallel.datagen import controls_block


class GridTable(NamedTuple):
    """A regular-lattice solution table.

    lows/steps/nums define the lattice (per input dim); outputs is
    (prod(nums), out_dim); valid marks feasible rows.
    """

    lows: torch.Tensor  # (D,)
    steps: torch.Tensor  # (D,)
    nums: tuple  # static (D,) python ints
    outputs: torch.Tensor  # (N, O)
    valid: torch.Tensor  # (N,) bool


def grid_table_from_arrays(inputs: np.ndarray, outputs: np.ndarray,
                           valid: Optional[np.ndarray] = None,
                           device=None) -> GridTable:
    """Build a GridTable from reference-format (inputs, outputs) npz arrays
    (meshgrid-flattened 'ij' order)."""
    device = resolve_device(device)
    d = inputs.shape[1]
    axes = [np.unique(inputs[:, i]) for i in range(d)]
    nums = tuple(len(a) for a in axes)
    assert int(np.prod(nums)) == inputs.shape[0], (
        "inputs are not a full regular lattice")
    lows = np.array([a[0] for a in axes])
    steps = np.array([(a[-1] - a[0]) / max(len(a) - 1, 1) if len(a) > 1
                      else 1.0 for a in axes])
    out_flat = controls_block(outputs)
    if valid is None:
        valid = ~np.any(out_flat == -999.0, axis=1)
    return GridTable(
        torch.as_tensor(lows, dtype=torch.float32, device=device),
        torch.as_tensor(steps, dtype=torch.float32, device=device), nums,
        torch.as_tensor(np.ascontiguousarray(out_flat), device=device),
        torch.as_tensor(np.asarray(valid, bool), device=device))


def _strides(nums, device) -> torch.Tensor:
    s = np.concatenate([np.cumprod(np.asarray(nums[1:])[::-1])[::-1], [1]])
    return torch.as_tensor(s.astype(np.int64), device=device)


def grid_lookup(table: GridTable, queries: torch.Tensor):
    """Nearest-lattice-row lookup, batched: (B, D) -> ((B, O), (B,) valid)."""
    dev = queries.device
    nums = torch.as_tensor(table.nums, dtype=torch.int64, device=dev)
    idx = torch.round((queries - table.lows) / table.steps).to(torch.int64)
    idx = torch.minimum(torch.clamp(idx, min=0), nums - 1)
    flat = torch.sum(idx * _strides(table.nums, dev), dim=-1)
    return table.outputs[flat], table.valid[flat]


def grid_lookup_linear(table: GridTable, queries: torch.Tensor):
    """Feasibility-weighted multilinear interpolation over the 2^D cell
    corners: (B, D) -> ((B, O), (B,) valid).

    Nearest-cell lookup quantizes every input to half a grid step; on a
    coarse curvature axis that holds the controls at the straight-road cell
    until the car is already mid-corner, then jumps a full cell (bang-bang
    between opposite control bounds on consecutive steps). Interpolating the
    surrounding corners gives controls continuous in the state. Infeasible
    corners get zero weight (their -999 rows never leak); ``valid`` is False
    only when ALL 2^D corners are infeasible."""
    dev = queries.device
    nums = table.nums
    d = len(nums)
    corners = torch.as_tensor(
        np.stack(np.meshgrid(*([[0, 1]] * d), indexing="ij"),
                 axis=-1).reshape(-1, d), device=dev)  # (2^D, D)
    nums_t = torch.as_tensor(nums, dtype=torch.int64, device=dev)
    u = (queries - table.lows) / table.steps
    # singleton-axis guard: for a dim with one grid value, nums - 2 is -1
    # and a plain clip would park the base index at -1, whose negative
    # stride aliases an unrelated table row into the blend; clamp the base
    # cell to 0 and zero that dim's fractional weight instead
    i0 = torch.minimum(torch.clamp(torch.floor(u).to(torch.int64), min=0),
                       torch.clamp(nums_t - 2, min=0))
    frac = torch.clamp(u - i0, 0.0, 1.0)  # (B, D)
    frac = torch.where(nums_t == 1, torch.zeros_like(frac), frac)
    idx = torch.minimum(i0[:, None, :] + corners, nums_t - 1)  # (B, C, D)
    flat = torch.sum(idx * _strides(nums, dev), dim=-1)  # (B, C)
    cw = torch.where(corners.bool(), frac[:, None, :],
                     1.0 - frac[:, None, :])
    w = torch.prod(cw, dim=-1) * table.valid[flat]  # feasibility-masked
    wsum = torch.sum(w, dim=-1)
    out = torch.einsum("bc,bco->bo", w.to(table.outputs.dtype),
                       table.outputs[flat])
    safe = torch.clamp(wsum, min=1e-12)
    return out / safe[:, None].to(out.dtype), wsum > 1e-6


def stack_grid_tables(tables: Sequence[GridTable]) -> GridTable:
    """Stack same-lattice tables (e.g. one per mu) into ONE GridTable with a
    leading integer 'arm' dimension.

    The arm index becomes grid dim 0 with lows=0, step=1: a query whose
    first coordinate is an exact integer arm id gets zero fractional weight
    on that axis, so both grid_lookup and grid_lookup_linear select exactly
    that arm's rows; a mixed-arm batch (each episode driving a different
    table, as the EXP3 adaptive planner does) stays ONE lookup instead of a
    per-arm Python fan-out."""
    base = tables[0]
    for t in tables[1:]:
        if t.nums != base.nums:
            raise ValueError("tables must share one lattice")
    a = len(tables)
    return GridTable(
        torch.cat([torch.zeros(1, dtype=base.lows.dtype,
                               device=base.lows.device), base.lows]),
        torch.cat([torch.ones(1, dtype=base.steps.dtype,
                              device=base.steps.device), base.steps]),
        (a,) + tuple(base.nums),
        torch.cat([t.outputs for t in tables], dim=0),
        torch.cat([t.valid for t in tables], dim=0))


class NNTable(NamedTuple):
    """Irregular table for brute-force nearest-neighbor lookup."""

    inputs: torch.Tensor  # (N, D), pre-scaled
    outputs: torch.Tensor  # (N, O)
    scale: torch.Tensor  # (D,) per-dim scaling applied to inputs


def nn_table_from_arrays(inputs, outputs, scale=None, device=None) -> NNTable:
    device = resolve_device(device)
    inputs = np.asarray(inputs, np.float32)
    out_flat = controls_block(outputs)
    valid = ~np.any(out_flat == -999.0, axis=1)
    inputs, out_flat = inputs[valid], out_flat[valid]
    if scale is None:
        span = inputs.max(0) - inputs.min(0)
        scale = 1.0 / np.where(span > 0, span, 1.0)
    return NNTable(torch.as_tensor(inputs * scale, device=device),
                   torch.as_tensor(out_flat, device=device),
                   torch.as_tensor(np.asarray(scale, np.float32),
                                   device=device))


def nn_lookup(table: NNTable, queries: torch.Tensor):
    """Exact nearest neighbor via ||q - x||^2 = ||q||^2 - 2 q.x + ||x||^2;
    the q.x term is one (B, N) matrix product, argmin over N."""
    q = queries * table.scale
    x_sq = torch.sum(table.inputs ** 2, dim=-1)
    cross = q @ table.inputs.T
    d2 = x_sq[None] - 2.0 * cross + torch.sum(q * q, dim=-1, keepdim=True)
    idx = torch.argmin(d2, dim=-1)
    return table.outputs[idx], idx


class ExplicitFrenetPlanner:
    """Plan by table lookup in the Frenet frame."""

    def __init__(self, table, track, use_grid: bool = True,
                 interpolate: bool = True, horizon_time: float = 0.5):
        """``interpolate``: multilinear over the surrounding cells (see
        grid_lookup_linear) instead of nearest-cell; GridTable only.
        ``horizon_time``: the table generator's horizon * dt, for
        horizon-end goal-speed sampling (sim.track.horizon_goal_speed).
        The table lives on the track's device."""
        self.table = table
        self.track = track
        self.use_grid = use_grid and isinstance(table, GridTable)
        self.interpolate = interpolate
        self.horizon_time = horizon_time
        self.device = track.raceline.ss.device

    @torch.no_grad()
    def plan_batch(self, s, ey, epsi, delta, vx, vy, wz):
        from irbfn_tpu_torch.sim.track import (horizon_goal_speed,
                                               interp_wrapped)

        rl = self.track.raceline
        s, ey, epsi, delta, vx, vy, wz = (
            torch.as_tensor(a, device=self.device)
            for a in (s, ey, epsi, delta, vx, vy, wz))
        curv = interp_wrapped(rl.ss, rl.ks, s, rl.length)
        vx_goal = horizon_goal_speed(rl, s, vx, self.horizon_time)
        q = torch.stack([ey, delta, vx, vy, vx_goal, wz, epsi, curv], dim=-1)
        if self.use_grid:
            lookup = grid_lookup_linear if self.interpolate else grid_lookup
            out, valid = lookup(self.table, q)
        else:
            out, _ = nn_lookup(self.table, q)
            valid = torch.ones(out.shape[:-1], dtype=torch.bool,
                               device=out.device)
        return out, valid

    def plan(self, obs) -> tuple:
        dtype = self.track.raceline.ss.dtype

        def t(v):
            return torch.atleast_1d(torch.as_tensor(v, dtype=dtype,
                                                    device=self.device))

        s, ey, epsi = self.track.cartesian_to_frenet(
            t(obs["pose_x"]), t(obs["pose_y"]), t(obs["pose_theta"]))
        out, valid = self.plan_batch(
            s, ey, epsi, t(obs["delta"]), t(obs["linear_vel_x"]),
            t(obs["linear_vel_y"]), t(obs["ang_vel_z"]))
        if not bool(valid[0]):
            return 0.0, 0.0  # infeasible cell: coast
        T = out.shape[-1] // 2
        return float(out[0, 0]), float(out[0, T])


class AdaptiveExplicitPlanner:
    """EXP3 over a bank of explicit tables."""

    def __init__(self, planners: Sequence, gamma: float = 0.2, seed: int = 0):
        from irbfn_tpu_torch.planning.bandits import EXP3

        self.planners = list(planners)
        self.bandit = EXP3(len(self.planners), gamma, seed)
        self.current_arm = 0

    def select(self) -> int:
        self.current_arm = self.bandit.pull_arm()
        return self.current_arm

    def reward(self, r: float):
        self.bandit.update_dist(self.current_arm, r)

    def plan(self, obs):
        return self.planners[self.current_arm].plan(obs)
