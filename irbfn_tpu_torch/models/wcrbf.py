"""Region-partitioned RBF network (WCRBFNet).

Port of ``irbfn_tpu/models/wcrbf.py``. The network is: a smooth box
indicator gamma over the regions, per-region gaussian (or other basis) RBF
features of the scaled distance ``||s*(x - c)|| / exp(log_sig)``, and a
linear head: one shared head over ``sum_r gamma_r phi_r``, or per-region
heads over normalised gammas. ``WCRBFNet.forward`` goes through the fused
op ``ops/rbf.py:wcrbf_forward`` (the CUDA kernel on the card).

``region_activation`` and ``rbf_distances`` are the flax path's pieces, kept
for the parity tests. ``DeeperWCRBFNet``, ``MLP`` and ``ClusterWCRBFNet``
are still to be ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS
from irbfn_tpu_torch.ops import rbf as _rbf


def build_region_bounds(lower_bounds, upper_bounds, dimension_ranges,
                        activation_idx):
    """Gather per-dimension segment bounds into dense (R, D) arrays:
    ``dimension_ranges[r][j]`` names region r's segment of split dim j."""
    n_regions = len(dimension_ranges)
    n_dims = len(activation_idx)
    lb = np.zeros((n_regions, n_dims))
    ub = np.zeros((n_regions, n_dims))
    for r, seg in enumerate(dimension_ranges):
        for j in range(n_dims):
            lb[r, j] = lower_bounds[j][int(seg[j])]
            ub[r, j] = upper_bounds[j][int(seg[j])]
    return lb, ub


def region_activation(x, lb, ub, delta, activation_idx):
    """Smooth box indicator gamma over the split dims, ``(B, F) -> (B, R)``;
    lb/ub (R, D), delta (D,) for the D dims in ``activation_idx``."""
    return _rbf.box_gate(x[:, list(activation_idx)], lb, ub, delta)


def rbf_distances(x, centers, log_sigs, input_scale=None):
    """Scaled distances ``||s*(x - c_rk)|| / exp(log_sig_rk)``, ``(B, R, K)``,
    with d^2 summed directly as ``sum_f (x_f - c_f)^2``."""
    if input_scale is not None:
        s = torch.as_tensor(input_scale, dtype=x.dtype, device=x.device)
        x = x * s
        centers = centers * s
    return _rbf.center_distances(x, centers) / torch.exp(log_sigs)[None]


class WCRBFNet(nn.Module):
    """Piecewise (region-partitioned) RBF network with a linear head.

    Parameters keep the flax layout, so a JAX checkpoint maps one to one
    (``train/checkpoints.py:params_from_jax``): ``centers`` (R, K, F),
    ``log_sigs`` (R, K), ``head_kernel`` (n_feat, O) and ``head_bias`` (O,),
    where n_feat is K for ``head_mode="shared"`` and R*K + R for
    ``"per_region"`` (block features ``[gamma_r phi_rk ; gamma_r]``).
    """

    def __init__(self, in_features: int, out_features: int,
                 num_kernels: int, basis_func: str, num_regions: int,
                 lower_bounds: Sequence[Sequence[float]],
                 upper_bounds: Sequence[Sequence[float]],
                 dimension_ranges: Sequence[Sequence[int]],
                 activation_idx: Sequence[int], delta: Sequence[float],
                 input_scale: Optional[Sequence[float]] = None,
                 head_mode: str = "shared", dtype=torch.float32,
                 device=None):
        super().__init__()
        if basis_func not in BASIS_FUNCTIONS:
            raise KeyError(f"unknown basis function {basis_func!r}; "
                           f"available: {sorted(BASIS_FUNCTIONS)}")
        if head_mode not in ("shared", "per_region"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.num_kernels = int(num_kernels)
        self.num_regions = int(num_regions)
        self.basis_func = basis_func
        self.head_mode = head_mode
        self.activation_idx = tuple(int(d) for d in activation_idx)
        R, K, F = self.num_regions, self.num_kernels, self.in_features
        n_feat = R * K + R if head_mode == "per_region" else K
        kw = dict(dtype=dtype, device=device)
        self.centers = nn.Parameter(torch.zeros((R, K, F), **kw))
        self.log_sigs = nn.Parameter(torch.zeros((R, K), **kw))
        self.head_kernel = nn.Parameter(torch.zeros((n_feat, out_features),
                                                    **kw))
        self.head_bias = nn.Parameter(torch.zeros((out_features,), **kw))

        # region gate embedded at full feature width: dims that are not
        # split get +-1e30 bounds (their gate factor is exactly 1)
        lb, ub = build_region_bounds(lower_bounds, upper_bounds,
                                     dimension_ranges, activation_idx)
        lb_full = np.full((R, F), -1e30)
        ub_full = np.full((R, F), 1e30)
        delta_full = np.ones((F,))
        for j, d in enumerate(self.activation_idx):
            lb_full[:, d] = lb[:, j]
            ub_full[:, d] = ub[:, j]
            delta_full[d] = float(delta[j])
        # (config constants, not part of the state_dict)
        for name, val in (("gate_lb", lb_full), ("gate_ub", ub_full),
                          ("gate_delta", delta_full),
                          ("input_scale", input_scale)):
            self.register_buffer(
                name, None if val is None else
                torch.as_tensor(np.asarray(val, np.float64), **kw),
                persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_scale is not None:
            x = x * self.input_scale.to(x.dtype)
        return _rbf.wcrbf_forward(x, _rbf.wcrbf_params_to_kernel(self))
