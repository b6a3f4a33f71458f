"""Cubic-spiral (polynomial-curvature) path representation and integration.

Port of ``irbfn_tpu/dynamics/spiral.py``:

- parameter layout ``[k0, k1, k2, k3, s_f]``: curvature values at arc-length
  fractions 0, 1/3, 2/3, 1 plus total arc length (the clothoid LUT's output
  format)
- ``params_to_coefs`` maps knots -> cubic polynomial coefficients via the
  fixed 4x4 Lagrange-interpolation matrix
- ``integrate_path``: the reference's running-average trapezoid, producing
  ``[x, y, theta, kappa, dx, dy]`` samples (N=9)
- ``integrate_endpoint_gl`` and ``sample_path``: composite Gauss-Legendre
  quadrature of (cos theta(s), sin theta(s)); theta(s) is a polynomial, so
  only the positions need quadrature. The nodes come from numpy, once per
  (order, segments, dtype, device).

Every function is batched over the leading axes and differentiable: the
clothoid endpoint loss (``train/trainer.py``) goes through
``integrate_endpoint_gl``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_PATH_POINTS = 9

# Lagrange interpolation of a cubic through curvature knots at s/sf = 0, 1/3,
# 2/3, 1; row i gives the coefficient of s^i before division by sf^i.
_KNOT_TO_COEF = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [-11.0 / 2.0, 9.0, -9.0 / 2.0, 1.0],
        [9.0, -45.0 / 2.0, 18.0, -9.0 / 2.0],
        [-9.0 / 2.0, 27.0 / 2.0, -27.0 / 2.0, 9.0 / 2.0],
    ]
)


@functools.lru_cache(maxsize=None)
def _knot_matrix(dtype, device) -> torch.Tensor:
    return torch.as_tensor(_KNOT_TO_COEF, dtype=dtype).to(device)


def params_to_coefs(params: torch.Tensor) -> torch.Tensor:
    """Map spiral params ``(..., 5)`` -> polynomial coefs ``(..., 4)`` of
    kappa(s) = a0 + a1 s + a2 s^2 + a3 s^3."""
    knots = params[..., :4]
    sf = params[..., 4]
    a = knots @ _knot_matrix(params.dtype, params.device).T
    powers = torch.stack([torch.ones_like(sf), sf, sf**2, sf**3], dim=-1)
    return a / powers


def curvature_theta(coefs: torch.Tensor, s: torch.Tensor):
    """kappa(s) and theta(s) = integral of kappa, batched: coefs
    ``(..., 4)``, s ``(...,)`` or broadcastable."""
    a0, a1, a2, a3 = (coefs[..., i] for i in range(4))
    kappa = a0 + s * (a1 + s * (a2 + s * a3))
    theta = s * (a0 + s * (a1 / 2.0 + s * (a2 / 3.0 + s * a3 / 4.0)))
    return kappa, theta


def integrate_path(params: torch.Tensor,
                   n_points: int = N_PATH_POINTS) -> torch.Tensor:
    """Trapezoid-rule spiral integration, batched: ``(..., n_points, 6)``
    samples ``[x, y, theta, kappa, dx, dy]`` at arc lengths
    ``linspace(0, sf, n_points)``; the running-average recursion reproduces
    the reference's incremental trapezoid exactly."""
    coefs = params_to_coefs(params)
    sf = params[..., 4]
    fracs = np.linspace(0.0, 1.0, n_points)
    theta_prev = torch.zeros_like(sf)
    dx = torch.zeros_like(sf)
    dy = torch.zeros_like(sf)
    states = []
    for k, frac in enumerate(fracs, start=1):
        s_k = float(frac) * sf
        kappa_k, theta_k = curvature_theta(coefs, s_k)
        dx = (dx * (1.0 - 1.0 / k)
              + (torch.cos(theta_k) + torch.cos(theta_prev)) / 2.0 / k)
        dy = (dy * (1.0 - 1.0 / k)
              + (torch.sin(theta_k) + torch.sin(theta_prev)) / 2.0 / k)
        states.append(torch.stack([s_k * dx, s_k * dy, theta_k, kappa_k, dx,
                                   dy], dim=-1))
        theta_prev = theta_k
    return torch.stack(states, dim=-2)


@functools.lru_cache(maxsize=None)
def _gl_nodes(order: int, segments: int, dtype, device):
    """Composite Gauss-Legendre nodes and weights on [0, 1], from numpy."""
    x, w = np.polynomial.legendre.leggauss(order)
    nodes, weights = [], []
    for i in range(segments):
        a, b = i / segments, (i + 1) / segments
        nodes.append((x + 1.0) * 0.5 * (b - a) + a)
        weights.append(w * 0.5 * (b - a))
    return (torch.as_tensor(np.concatenate(nodes), dtype=dtype).to(device),
            torch.as_tensor(np.concatenate(weights), dtype=dtype).to(device))


def integrate_endpoint_gl(params: torch.Tensor, order: int = 16,
                          segments: int = 4) -> torch.Tensor:
    """High-accuracy endpoint ``[x, y, theta, kappa]`` via composite
    Gauss-Legendre quadrature of (cos theta(s), sin theta(s)), batched;
    order*segments = 64 nodes give < 1e-12 relative error over the lattice
    ranges of the reference LUTs."""
    coefs = params_to_coefs(params)
    sf = params[..., 4]
    nodes, weights = _gl_nodes(order, segments, params.dtype, params.device)
    s_nodes = sf[..., None] * nodes  # (..., Q)
    _, theta_nodes = curvature_theta(coefs[..., None, :], s_nodes)
    x = sf * torch.sum(weights * torch.cos(theta_nodes), dim=-1)
    y = sf * torch.sum(weights * torch.sin(theta_nodes), dim=-1)
    kappa_f, theta_f = curvature_theta(coefs, sf)
    return torch.stack([x, y, theta_f, kappa_f], dim=-1)


def sample_path(params: torch.Tensor, n_points: int = N_PATH_POINTS,
                order: int = 8) -> torch.Tensor:
    """Accurate spiral path sampling: ``(..., n_points, 4)`` of
    ``[x, y, theta, kappa]`` at arc lengths ``linspace(0, sf, n_points)``.
    Each segment is integrated with ``order``-point Gauss-Legendre and
    cumulatively summed (``integrate_path`` is the reference's first-order
    trapezoid)."""
    coefs = params_to_coefs(params)
    sf = params[..., 4]
    x_gl, w_gl = _gl_nodes(order, 1, params.dtype, params.device)
    n_seg = n_points - 1
    h = sf / n_seg  # (...,)
    # segment start fractions (n_seg,) -> node positions (..., n_seg, order)
    seg0 = torch.arange(n_seg, dtype=params.dtype, device=params.device)
    s_nodes = (seg0[:, None] + x_gl[None, :]) * h[..., None, None]
    _, theta_nodes = curvature_theta(coefs[..., None, None, :], s_nodes)
    dx_seg = h[..., None] * torch.sum(w_gl * torch.cos(theta_nodes), dim=-1)
    dy_seg = h[..., None] * torch.sum(w_gl * torch.sin(theta_nodes), dim=-1)
    zeros = torch.zeros_like(dx_seg[..., :1])
    xs = torch.cumsum(torch.cat([zeros, dx_seg], dim=-1), dim=-1)
    ys = torch.cumsum(torch.cat([zeros, dy_seg], dim=-1), dim=-1)
    fracs = torch.linspace(0.0, 1.0, n_points, dtype=params.dtype,
                           device=params.device)
    s_samples = sf[..., None] * fracs
    kappa_s, theta_s = curvature_theta(coefs[..., None, :], s_samples)
    return torch.stack([xs, ys, theta_s, kappa_s], dim=-1)


def clothoid_to_params(k0, dk, s):
    """Convert a clothoid (linear-curvature) solution to the 5-param spiral
    layout: curvature knots at s/3 spacings."""
    k1 = k0 + dk * s / 3.0
    k2 = k0 + 2.0 * dk * s / 3.0
    k3 = k0 + dk * s
    return torch.stack([k0, k1, k2, k3, s], dim=-1)
