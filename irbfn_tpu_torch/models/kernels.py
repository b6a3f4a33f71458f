"""Radial-basis-function kernel zoo + registry.

Port of ``irbfn_tpu/models/kernels.py``: the same 15 elementwise maps
``alpha -> phi(alpha)`` on the scaled center distances, in the same
registry order. The order is an ABI: ``ops/csrc/rbf_forward.cu`` selects
the basis by its index in ``BASIS_FUNCTIONS``.
"""

from __future__ import annotations

import torch

_SQRT3 = 3.0**0.5
_SQRT5 = 5.0**0.5


def gaussian(alpha):
    return torch.exp(-(alpha**2))


def gaussian_wide(alpha):
    return torch.exp(-0.1 * alpha**2)


def gaussian_wider(alpha):
    return torch.exp(-0.01 * alpha**2)


def gaussian_narrow(alpha):
    return torch.exp(-10.0 * alpha**2)


def gaussian_narrower(alpha):
    return torch.exp(-100.0 * alpha**2)


def inverse_quadratic(alpha):
    return 1.0 / (1.0 + alpha**2)


def linear(alpha):
    return alpha


def quadratic(alpha):
    return alpha**2


def multiquadric(alpha):
    return torch.sqrt(1.0 + alpha**2)


def inverse_multiquadric(alpha):
    return 1.0 / torch.sqrt(1.0 + alpha**2)


def spline(alpha):
    return alpha**2 * torch.log(alpha + 1.0)


def poisson_one(alpha):
    return (alpha - 1.0) * torch.exp(-alpha)


def poisson_two(alpha):
    return ((alpha - 2.0) / 2.0) * alpha * torch.exp(-alpha)


def matern32(alpha):
    return (1.0 + _SQRT3 * alpha) * torch.exp(-_SQRT3 * alpha)


def matern52(alpha):
    return ((1.0 + _SQRT5 * alpha + (5.0 / 3.0) * alpha**2)
            * torch.exp(-_SQRT5 * alpha))


BASIS_FUNCTIONS = {
    fn.__name__: fn
    for fn in (
        gaussian, gaussian_wide, gaussian_wider, gaussian_narrow,
        gaussian_narrower, inverse_quadratic, linear, quadratic, multiquadric,
        inverse_multiquadric, spline, poisson_one, poisson_two, matern32,
        matern52,
    )
}


def get_basis(name_or_fn):
    """Resolve a basis function from a name (config round-trip) or callable."""
    if callable(name_or_fn):
        return name_or_fn
    try:
        return BASIS_FUNCTIONS[name_or_fn]
    except KeyError:
        raise KeyError(
            f"unknown basis function {name_or_fn!r}; "
            f"available: {sorted(BASIS_FUNCTIONS)}") from None
