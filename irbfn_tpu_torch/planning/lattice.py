"""Lattice planner: sample a goal grid, map every goal to a spiral, integrate
the spirals, score them, and select by softargmin.

Port of ``irbfn_tpu/planning/lattice.py``: lookahead-square goal sampling,
one batched goal -> spiral map (a trained net's forward, or the exact
clothoid solver), spiral integration, a target + curvature + obstacle cost,
and two selections: the softargmin blend (smooth, differentiable) and the
hard argmin (safe when the blend would average symmetric detours back into
an obstacle).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.spiral import sample_path
from irbfn_tpu_torch.solvers.clothoid import solve_g1_lattice


class LatticePlan(NamedTuple):
    best_params: torch.Tensor  # (5,) softargmin-blended spiral params
    best_path: torch.Tensor  # (n_pts, 4) [x, y, theta, kappa]
    argmin_params: torch.Tensor  # (5,) hard-argmin params
    argmin_path: torch.Tensor  # (n_pts, 4)
    costs: torch.Tensor  # (G,) per-goal cost
    weights: torch.Tensor  # (G,) softargmin weights
    goals: torch.Tensor  # (G, 3) sampled goals


def sample_lookahead_grid(lookahead: float, half_width: float, n_lon: int,
                          n_lat: int, n_theta: int, theta_range: float = 0.6,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """Goal grid ahead of the ego frame: x in [la/2, la], y in
    +-half_width, theta in +-theta_range, 'ij' order: ``(G, 3)`` on
    ``device`` (None: the card)."""
    xs = np.linspace(lookahead * 0.5, lookahead, n_lon)
    ys = np.linspace(-half_width, half_width, n_lat)
    ts = np.linspace(-theta_range, theta_range, n_theta)
    X, Y, T = np.meshgrid(xs, ys, ts, indexing="ij")
    grid = np.stack([X, Y, T], axis=-1).reshape(-1, 3).astype(np.float32)
    return torch.as_tensor(grid).to(resolve_device(device), dtype)


def plan_lattice(param_fn: Callable, goals: torch.Tensor, target_xy,
                 obstacle_xy=None, n_path_points: int = 9,
                 temperature: float = 50.0,
                 obstacle_radius: float = 1.0) -> LatticePlan:
    """Evaluate every candidate goal and select a spiral.

    Args:
        param_fn: batched map ``(G, 3)`` goals -> ``(G, 5)`` spiral params.
        goals: ``(G, 3)`` candidate goals in the ego frame.
        target_xy: ``(2,)`` desired position (e.g. a raceline lookahead).
        obstacle_xy: optional ``(M, 2)`` obstacle centers.
    """
    dt, dev = goals.dtype, goals.device
    target_xy = torch.as_tensor(target_xy, dtype=dt, device=dev)
    params = param_fn(goals)  # (G, 5)
    paths = sample_path(params, n_points=n_path_points)  # (G, P, 4)
    endpoints = paths[:, -1, :2]
    cost = torch.sum((endpoints - target_xy) ** 2, dim=-1)
    # curvature-effort regulariser
    cost = cost + 0.1 * torch.mean(paths[..., 3] ** 2, dim=-1)
    if obstacle_xy is not None:
        obstacle_xy = torch.as_tensor(obstacle_xy, dtype=dt, device=dev)
        d = torch.linalg.norm(paths[:, :, None, :2] - obstacle_xy[None, None],
                              dim=-1)  # (G, P, M)
        clearance = torch.amin(d, dim=(1, 2))
        cost = cost + 1e3 * torch.clamp(obstacle_radius - clearance,
                                        min=0.0) ** 2
    # the blend can average symmetric detours (+-y around an obstacle) back
    # into it: argmin_* is the hard selection to execute, weights and best_*
    # are for gradients
    weights = torch.softmax(-temperature * cost, dim=0)
    best_params = torch.einsum("g,gp->p", weights, params)
    best_path = sample_path(best_params, n_points=n_path_points)
    k = torch.argmin(cost)
    return LatticePlan(best_params, best_path, params[k], paths[k], cost,
                       weights, goals)


class LatticePlanner:
    """A fixed goal grid and a goal -> spiral map: a trained net
    (``model``, a ``WCRBFNet``: one forward per plan, on the card the fused
    RBF kernel) or, without a model, the exact clothoid solver."""

    def __init__(self, model=None, lookahead: float = 15.0,
                 half_width: float = 6.0, grid=(8, 9, 5),
                 temperature: float = 50.0, device=None):
        if model is not None and device is None:
            device = next(model.parameters()).device
        self.goals = sample_lookahead_grid(lookahead, half_width, *grid,
                                           device=device)
        self.temperature = temperature
        self.model = model

    def _param_fn(self, g: torch.Tensor) -> torch.Tensor:
        if self.model is None:
            return solve_g1_lattice(g)
        with torch.no_grad():
            return self.model(g)

    def plan(self, target_xy, obstacles: Optional[object] = None
             ) -> LatticePlan:
        return plan_lattice(self._param_fn, self.goals, target_xy,
                            obstacle_xy=obstacles,
                            temperature=self.temperature)


__all__ = ["LatticePlan", "LatticePlanner", "plan_lattice",
           "sample_lookahead_grid"]
