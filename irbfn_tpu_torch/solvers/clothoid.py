"""Batched clothoid G1-Hermite boundary-value solver.

Port of ``irbfn_tpu/solvers/clothoid.py``: given the start pose (0, 0, 0)
and a goal pose (x, y, theta), find the linear-curvature spiral
``kappa(s) = k0 + dk * s`` of length ``L`` that connects them.

Method (the standard G1-fitting reduction): in the goal-aligned frame with
``phi = atan2(dy, dx)``, ``r = |d|``, ``phi0 = wrap(th0 - phi)``,
``phi1 = wrap(th1 - phi)``, ``delta = phi1 - phi0``, the normalised heading
is ``theta(tau) = phi0 + (delta - a/2) tau + a tau^2 / 2`` with the single
unknown ``a = dk L^2``. The y-endpoint condition

    g(a) = int_0^1 sin(theta(tau)) dtau = 0

is solved by a fixed number of Newton sweeps from the small-angle start
``a0 = 6 (phi0 + phi1)``, each step clipped to +-10; then
``L = r / int_0^1 cos(theta(tau)) dtau``, ``k0 = (delta - a/2) / L`` and
``dk = a / L^2``. The integrals are composite Gauss-Legendre quadratures
(order 12 on 4 segments: 48 nodes).

Everything is elementwise over a ``(rows, 48)`` node axis, with no
per-goal Python. The rows go through in chunks of ``chunk`` so that a
multi-million-goal lattice never holds a ``(rows, 48)`` tensor at once. The
JAX package computes this with XLA's arithmetic (no Pallas kernel), so this
is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.spiral import clothoid_to_params

# rows per elementwise pass: (chunk, 48) f32 intermediates of 50 MB
CHUNK = 1 << 18


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


class ClothoidSolution(NamedTuple):
    k0: torch.Tensor  # initial curvature (...,)
    dk: torch.Tensor  # curvature rate (...,)
    length: torch.Tensor  # arc length (...,)
    residual: torch.Tensor  # |g(a)| at the solution (...,)
    converged: torch.Tensor  # bool (...,)

    @property
    def params(self) -> torch.Tensor:
        """Spiral-parameter layout ``[k0, k1, k2, k3, s]`` (the LUT's)."""
        return clothoid_to_params(self.k0, self.dk, self.length)


def _quad_nodes(order: int, segments: int, dtype, device=None):
    """Composite Gauss-Legendre nodes and weights on [0, 1], from numpy."""
    x, w = np.polynomial.legendre.leggauss(order)
    nodes, weights = [], []
    for i in range(segments):
        a, b = i / segments, (i + 1) / segments
        nodes.append((x + 1.0) * 0.5 * (b - a) + a)
        weights.append(w * 0.5 * (b - a))
    return (torch.as_tensor(np.concatenate(nodes), dtype=dtype).to(device),
            torch.as_tensor(np.concatenate(weights), dtype=dtype).to(device))


def _solve_flat(gx, gy, gth, sx, sy, sth, newton_iters: int, tau, w):
    """The G1 solve of flat ``(B,)`` goals; see the module docstring."""
    dx = gx - sx
    dy = gy - sy
    r = torch.sqrt(dx * dx + dy * dy)
    phi = torch.atan2(dy, dx)
    phi0 = wrap_angle(sth - phi)
    phi1 = wrap_angle(gth - phi)
    delta = phi1 - phi0
    tau2 = tau ** 2
    dphase_da = 0.5 * (tau2 - tau)

    def phase(a):
        # theta(tau) = phi0 + (delta - a/2) tau + (a/2) tau^2
        return (phi0[:, None] + (delta - 0.5 * a)[:, None] * tau
                + (0.5 * a)[:, None] * tau2)

    a = 6.0 * (phi0 + phi1)  # small-angle closed-form start
    for _ in range(newton_iters):
        p = phase(a)
        g = torch.sum(w * torch.sin(p), dim=-1)
        dg = torch.sum(w * torch.cos(p) * dphase_da, dim=-1)
        tiny = torch.full_like(dg, 1e-12)
        tiny = torch.where(dg < 0, -tiny, tiny)
        dg_safe = torch.where(dg.abs() < 1e-12, tiny, dg)
        # clipped steps keep the oscillatory-integrand regime stable
        a = a - torch.clamp(g / dg_safe, -10.0, 10.0)

    p = phase(a)
    X = torch.sum(w * torch.cos(p), dim=-1)
    Y = torch.sum(w * torch.sin(p), dim=-1)
    g_final = Y.abs()
    X_safe = torch.where(X.abs() < 1e-12, torch.full_like(X, 1e-12), X)
    L = r / X_safe
    # a degenerate same-point goal is a zero-length straight segment
    degenerate = r < 1e-12
    zero = torch.zeros_like(L)
    L = torch.where(degenerate, zero, L)
    L_div = torch.where(L == 0, torch.ones_like(L), L)
    k0 = torch.where(degenerate, zero, (delta - 0.5 * a) / L_div)
    dk = torch.where(degenerate, zero, a / L_div ** 2)
    converged = (g_final < 1e-8) & (L >= 0.0) & ~degenerate
    return k0, dk, L, g_final, converged


def solve_g1_hermite(goal_x, goal_y, goal_theta, *, start_x=0.0,
                     start_y=0.0, start_theta=0.0, newton_iters: int = 10,
                     order: int = 12, segments: int = 4, chunk: int = CHUNK,
                     device=None) -> ClothoidSolution:
    """Solve the G1-Hermite clothoid BVP, batched over leading axes.

    Args:
        goal_x, goal_y, goal_theta: goal pose arrays ``(...,)``; a tensor
            stays where it is unless ``device`` names a place, anything
            else goes to ``device`` (None: the card).
        start_*: start pose (scalar or broadcastable); the table generator
            always uses the origin.
        newton_iters: fixed Newton sweeps on the reduced 1-D G1 equation
            (the JAX package measured full convergence by 6 on the whole
            reference range and adversarial corners; 10 keeps a margin).
        chunk: rows per elementwise pass.
    """
    if torch.is_tensor(goal_x) and device is None:
        dev = goal_x.device
    else:
        dev = resolve_device(device)
    gx = torch.as_tensor(goal_x, device=dev)
    if not gx.is_floating_point():
        gx = gx.to(torch.get_default_dtype())
    dtype = gx.dtype
    gy = torch.as_tensor(goal_y, dtype=dtype, device=dev)
    gth = torch.as_tensor(goal_theta, dtype=dtype, device=dev)
    shape = torch.broadcast_shapes(gx.shape, gy.shape, gth.shape)
    gx, gy, gth = (t.expand(shape).reshape(-1) for t in (gx, gy, gth))
    starts = [torch.as_tensor(s, dtype=dtype, device=dev)
              for s in (start_x, start_y, start_theta)]
    starts = [s.expand(shape).reshape(-1) if s.ndim else s for s in starts]
    tau, w = _quad_nodes(order, segments, dtype, dev)
    parts = []
    for i0 in range(0, max(gx.shape[0], 1), chunk):
        sl = slice(i0, i0 + chunk)
        sx, sy, sth = (s[sl] if s.ndim else s for s in starts)
        parts.append(_solve_flat(gx[sl], gy[sl], gth[sl], sx, sy, sth,
                                 newton_iters, tau, w))
    out = [torch.cat(f) if len(parts) > 1 else f[0] for f in zip(*parts)]
    return ClothoidSolution(*[o.reshape(shape) for o in out])


def solve_g1_lattice(goals, **kw) -> torch.Tensor:
    """Solve a ``(..., 3)`` lattice of [x, y, theta] goals -> ``(..., 5)``
    spiral params ``[k0, k1, k2, k3, s]``: the LUT row format of the
    reference's clothoid table."""
    return solve_g1_hermite(goals[..., 0], goals[..., 1], goals[..., 2],
                            **kw).params


__all__ = ["ClothoidSolution", "solve_g1_hermite", "solve_g1_lattice",
           "wrap_angle"]
