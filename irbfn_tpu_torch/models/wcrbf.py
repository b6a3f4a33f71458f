"""Region-partitioned RBF networks (the WCRBFNet model family).

Port of ``irbfn_tpu/models/wcrbf.py``. A WCRBFNet is: a smooth box
indicator gamma over the regions, per-region gaussian (or other basis) RBF
features of the scaled distance ``||s*(x - c)|| / exp(log_sig)``, and a
linear head: one shared head over ``sum_r gamma_r phi_r``, or per-region
heads over normalised gammas.

``WCRBFNet.forward`` has two routes, and the grad mode alone picks one:

- when autograd records and the input or any parameter requires a gradient,
  the **module path** (``forward_module``): plain differentiable tensor
  operations on whatever device the tensors are, the counterpart of the
  module that JAX training differentiates;
- otherwise the **fused op** ``ops/rbf.py:wcrbf_forward``, which on a CUDA
  tensor launches the hand-written kernel (or raises) and on a CPU tensor
  runs its plain version.

Neither route is a fallback for the other: a kernel that cannot build or
launch raises.

A model with a region core can hold a shard of it: ``parallel/mesh.py:
shard_params`` keeps regions ``[start, stop)`` of ``centers`` and
``log_sigs`` on each rank of an expert group (``expert_shard``). The gate
constants, the gate layer and the heads stay whole. Every route then sums
its regions' share of the output (or, for ``DeeperWCRBFNet``, of the
blended features) over the group with one ``all_reduce``: the fused op in
its partial mode, whose gate sum is reduced beside the numerator before the
divide, and the module path with an ``all_reduce`` that autograd sees
(``expert_sum``).

``DeeperWCRBFNet`` (an MLP head over the blended features), ``MLP`` (the
plain baseline) and ``ClusterWCRBFNet`` (a learned softmax gate; returns
``(y, logits)``) run through plain tensor operations only, as they do in
the JAX package. Every Dense weight keeps the JAX package's ``(in, out)``
layout, so a JAX checkpoint maps one to one (``train/checkpoints.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS
from irbfn_tpu_torch.ops import rbf as _rbf
from irbfn_tpu_torch.utils import prng


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


def overlapping_segments(values, n_segments: int, num_overlap: int = 1):
    """Per-dimension segment bounds where neighbouring segments overlap by
    ``num_overlap`` grid values. Returns (lower, upper) lists of length
    n_segments."""
    values = np.sort(np.unique(np.asarray(values)))
    edges = np.linspace(0, len(values) - 1, n_segments + 1, dtype=int)
    lower, upper = [], []
    for s in range(n_segments):
        lo_i = max(0, edges[s] - (num_overlap if s > 0 else 0))
        hi_i = min(len(values) - 1,
                   edges[s + 1] + (num_overlap if s < n_segments - 1 else 0))
        lower.append(float(values[lo_i]))
        upper.append(float(values[hi_i]))
    return lower, upper


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


def region_features(x, region_weights, centers, log_sigs, basis_func,
                    input_scale=None, head_mode: str = "shared"):
    """Region-blended RBF features, ``(B, F) -> (B, K)`` for ``"shared"``
    (``sum_r w_r phi_r``) or ``(B, R*K + R)`` for ``"per_region"`` (block
    features ``[w_r phi_rk ; w_r]``: a Dense head over them is a per-region
    linear model blended by the region weights). Materialises the (B, R, K)
    basis tensor; differentiable in every argument."""
    phi = BASIS_FUNCTIONS[basis_func](
        rbf_distances(x, centers, log_sigs, input_scale=input_scale))
    if head_mode == "per_region":
        weighted = region_weights[:, :, None] * phi  # (B, R, K)
        return torch.cat([weighted.reshape(x.shape[0], -1), region_weights],
                         dim=-1)
    return torch.einsum("br,brk->bk", region_weights, phi)


class ExpertShard(NamedTuple):
    """A model's share of its region core: regions ``[start, stop)``, held
    by rank ``rank`` of the ``size`` ranks of the expert ``group`` (a
    ``torch.distributed`` process group)."""

    start: int
    stop: int
    group: object
    rank: int
    size: int


class _ExpertSum(torch.autograd.Function):
    """``all_reduce`` (sum) over the expert group. Every rank of the group
    reads the sum, so the gradient of each rank's input is the sum of the
    group's output gradients: the backward is an ``all_reduce`` too. A
    loss that every rank of the group computes alike is thereby counted
    once per rank: the train step scales it (``train/trainer.py:
    make_train_step``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def expert_sum(t: torch.Tensor, shard: Optional[ExpertShard]):
    """``t`` summed over the ranks of ``shard``'s expert group, with the
    backward above; ``t`` itself for a whole model or a group of one."""
    if shard is None or shard.size == 1:
        return t
    return _ExpertSum.apply(t, shard.group)


def _check_basis(basis_func: str):
    if basis_func not in BASIS_FUNCTIONS:
        raise KeyError(f"unknown basis function {basis_func!r}; "
                       f"available: {sorted(BASIS_FUNCTIONS)}")


class _RBFModule(nn.Module):
    """What the four model classes share: Dense layers as ``<name>_kernel``
    (in, out) and ``<name>_bias`` parameters, the center bank, and flax's
    initial values."""

    def _add_dense(self, name: str, fan_in: int, fan_out: int, kw: dict):
        setattr(self, f"{name}_kernel",
                nn.Parameter(torch.zeros((fan_in, fan_out), **kw)))
        setattr(self, f"{name}_bias",
                nn.Parameter(torch.zeros((fan_out,), **kw)))

    def _dense(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return (h @ getattr(self, f"{name}_kernel")
                + getattr(self, f"{name}_bias"))

    expert_shard: Optional[ExpertShard] = None  # set by shard_params

    def _add_core(self, R: int, K: int, F: int, kw: dict):
        self.num_regions = R
        self.centers = nn.Parameter(torch.zeros((R, K, F), **kw))
        self.log_sigs = nn.Parameter(torch.zeros((R, K), **kw))

    def region_range(self):
        """``(start, stop)``: the regions of the core this module holds."""
        s = self.expert_shard
        return (0, self.num_regions) if s is None else (s.start, s.stop)

    def _sharded_features(self, x, weights, head_mode: str = "shared"):
        """``region_features`` over the regions this module holds, with
        ``weights`` (B, R) over all of them."""
        r0, r1 = self.region_range()
        return region_features(x, weights[:, r0:r1], self.centers,
                               self.log_sigs, self.basis_func,
                               self.input_scale, head_mode)

    def _register_constant(self, name: str, val, kw: dict):
        """A config constant: a buffer that is not part of the state_dict."""
        self.register_buffer(
            name, None if val is None else
            torch.as_tensor(np.asarray(val, np.float64), **kw),
            persistent=False)

    @torch.no_grad()
    def reset_parameters(self, key, centers=None):
        """The initial values flax's ``module.init(key, x)`` gives the JAX
        class: each Dense kernel LeCun normal from its layer's key, biases
        zero; centers unit normal from the core's key, or ``centers`` ((K, F),
        shared by every region, or (R, K, F)) as a warm start; log-widths
        zero. ``key`` is a ``utils/prng.py`` key or an int seed (its
        ``PRNGKey``). Drawn in f32 on the host, as JAX makes them, then cast
        to the module's dtype."""
        key = prng.as_key(key, "cpu")
        for name, p in self.named_parameters():
            if name.endswith("_kernel"):
                v = prng.lecun_normal(
                    prng.param_key(key, _flax_scope(name)), p.shape)
            elif name == "centers" and centers is None:
                # a frozen bank is a constant the JAX class draws from
                # PRNGKey(0); a trainable one is the core's first parameter
                v = prng.normal(prng.param_key(key, "core")
                                if p.requires_grad else prng.PRNGKey(0),
                                p.shape)
            elif name == "centers":
                v = torch.as_tensor(np.asarray(centers, np.float64)).expand(
                    p.shape)
            else:
                v = torch.zeros(p.shape)
            p.copy_(v)
        return self


def _init_key(seed, key):
    """A constructor's initial-value key: ``key``, else ``PRNGKey(seed)``,
    else None."""
    return key if key is not None or seed is None else prng.PRNGKey(seed)


def _flax_scope(name: str) -> str:
    """The flax Dense module of the port's ``<layer>_kernel``: ``Dense_<i>``
    for the MLP's ``dense<i>``, else the layer's name (``head``, ``pre1``,
    ``gate``)."""
    layer = name.rsplit("_", 1)[0]
    if layer.startswith("dense"):
        return f"Dense_{layer[5:]}"
    return layer


class WCRBFNet(_RBFModule):
    """Piecewise (region-partitioned) RBF network with a linear head.

    Parameters keep the JAX package's layout, so a JAX checkpoint maps one
    to one (``train/checkpoints.py:params_from_jax``): ``centers`` (R, K, F),
    ``log_sigs`` (R, K), ``head_kernel`` (n_feat, O) and ``head_bias`` (O,),
    where n_feat is K for ``head_mode="shared"`` and R*K + R for
    ``"per_region"`` (block features ``[gamma_r phi_rk ; gamma_r]``).

    ``centers`` ((K, F) or (R, K, F)) warm-starts the center bank;
    ``fixed_centers`` freezes it and ``fixed_width`` the log-widths as well
    (frozen tensors stay parameters of the ``state_dict`` with
    ``requires_grad=False``, and a checkpoint keeps them in the JAX package's
    ``constants`` collection). ``key`` (a ``utils/prng.py`` key; ``seed=s``
    means ``PRNGKey(s)``) draws flax's initial values
    (``reset_parameters``); without either every weight starts at zero, to
    be loaded or fitted.
    """

    def __init__(self, in_features: int, out_features: int,
                 num_kernels: int, basis_func: str, num_regions: int,
                 lower_bounds: Sequence[Sequence[float]],
                 upper_bounds: Sequence[Sequence[float]],
                 dimension_ranges: Sequence[Sequence[int]],
                 activation_idx: Sequence[int], delta: Sequence[float],
                 input_scale: Optional[Sequence[float]] = None,
                 head_mode: str = "shared", dtype=torch.float32,
                 device=None, centers=None, fixed_centers: bool = False,
                 fixed_width: bool = False, seed: Optional[int] = None,
                 key=None):
        super().__init__()
        _check_basis(basis_func)
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
        kw = dict(dtype=dtype, device=resolve_device(device))
        self._add_core(R, K, F, kw)
        self._add_dense("head", n_feat, out_features, kw)

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
        for name, val in (("gate_lb", lb_full), ("gate_ub", ub_full),
                          ("gate_delta", delta_full),
                          ("input_scale", input_scale)):
            self._register_constant(name, val, kw)

        self._operands = (None, None)  # (key, RBFOperands) of the last pack
        self.centers.requires_grad_(not fixed_centers)
        self.log_sigs.requires_grad_(not fixed_width)
        key = _init_key(seed, key)
        if key is not None or centers is not None:
            self.reset_parameters(0 if key is None else key, centers)

    def kernel_operands(self) -> "_rbf.RBFOperands":
        """``ops/rbf.py:wcrbf_params_to_kernel(self)``, packed once and kept
        until a weight or a gate constant changes (in place, or by moving the
        module). While autograd records, nothing is kept: the operands must
        then stay functions of the parameters."""
        src = [t for t in (self.centers, self.log_sigs, self.head_kernel,
                           self.head_bias, self.gate_lb, self.gate_ub,
                           self.gate_delta, self.input_scale)
               if t is not None]
        if torch.is_grad_enabled() and any(t.requires_grad for t in src):
            return _rbf.wcrbf_params_to_kernel(self)
        key = tuple((t.data_ptr(), t.dtype,
                     0 if t.is_inference() else t._version) for t in src)
        if self._operands[0] != key:
            with torch.no_grad():
                self._operands = (key, _rbf.wcrbf_params_to_kernel(self))
        return self._operands[1]

    def forward_module(self, x: torch.Tensor) -> torch.Tensor:
        """The module path: gate, (B, R, K) features and Dense head as plain
        differentiable tensor operations, on any device."""
        act = list(self.activation_idx)
        gamma = _rbf.box_gate(x[:, act], self.gate_lb[:, act].to(x.dtype),
                              self.gate_ub[:, act].to(x.dtype),
                              self.gate_delta[act].to(x.dtype))
        if self.head_mode == "per_region":
            gamma = gamma / (gamma.sum(-1, keepdim=True) + 1e-9)
        if self.expert_shard is not None:
            return self._sharded_head(x, gamma)
        feats = region_features(x, gamma, self.centers, self.log_sigs,
                                self.basis_func, self.input_scale,
                                self.head_mode)
        return self._dense("head", feats)

    def _sharded_head(self, x, gamma):
        """The module path of a shard: this rank's regions through their
        rows of the head, summed over the expert group, plus the bias."""
        feats = self._sharded_features(x, gamma, self.head_mode)
        w = self.head_kernel
        if self.head_mode == "per_region":
            (r0, r1), R, K = self.region_range(), self.num_regions, \
                self.num_kernels
            w = torch.cat([w[r0 * K:r1 * K], w[R * K + r0:R * K + r1]])
        return expert_sum(feats @ w, self.expert_shard) + self.head_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, F) -> (B, O)``. When autograd records and ``x`` or any
        parameter requires a gradient: the module path. Otherwise the fused
        op, which launches the CUDA kernel on a CUDA tensor or raises. The
        grad mode decides, never a failure of either route."""
        if torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in self.parameters())):
            return self.forward_module(x)
        if self.input_scale is not None:
            x = x * self.input_scale.to(x.dtype)
        ops = self.kernel_operands()
        if self.expert_shard is None:
            return _rbf.wcrbf_forward(x, ops)
        part = _rbf.wcrbf_forward(x.contiguous(), ops, partial=True)
        return _rbf.finish_partial(expert_sum(part, self.expert_shard), ops)


def _geometric_gate(module, lower_bounds, upper_bounds, dimension_ranges,
                    activation_idx, delta, kw):
    lb, ub = build_region_bounds(lower_bounds, upper_bounds,
                                 dimension_ranges, activation_idx)
    module.activation_idx = tuple(int(d) for d in activation_idx)
    for name, val in (("gate_lb", lb), ("gate_ub", ub), ("gate_delta", delta)):
        module._register_constant(name, val, kw)


class DeeperWCRBFNet(_RBFModule):
    """WCRBFNet features (shared blend) with a 2x Dense(hidden)+relu MLP
    head: ``pre1``, ``pre2``, ``head``."""

    def __init__(self, in_features: int, out_features: int,
                 num_kernels: int, basis_func: str, num_regions: int,
                 lower_bounds, upper_bounds, dimension_ranges,
                 activation_idx, delta, hidden: int = 64,
                 input_scale: Optional[Sequence[float]] = None,
                 dtype=torch.float32, device=None,
                 seed: Optional[int] = None, key=None):
        super().__init__()
        _check_basis(basis_func)
        self.basis_func = basis_func
        kw = dict(dtype=dtype, device=resolve_device(device))
        self._add_core(int(num_regions), int(num_kernels), int(in_features),
                       kw)
        self._add_dense("pre1", int(num_kernels), hidden, kw)
        self._add_dense("pre2", hidden, hidden, kw)
        self._add_dense("head", hidden, int(out_features), kw)
        _geometric_gate(self, lower_bounds, upper_bounds, dimension_ranges,
                        activation_idx, delta, kw)
        self._register_constant("input_scale", input_scale, kw)
        key = _init_key(seed, key)
        if key is not None:
            self.reset_parameters(key)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma = region_activation(x, self.gate_lb.to(x.dtype),
                                  self.gate_ub.to(x.dtype),
                                  self.gate_delta.to(x.dtype),
                                  self.activation_idx)
        feats = expert_sum(self._sharded_features(x, gamma),
                           self.expert_shard)
        h = torch.relu(self._dense("pre1", feats))
        h = torch.relu(self._dense("pre2", h))
        return self._dense("head", h)


class MLP(_RBFModule):
    """Plain MLP baseline with the WCRBF constructor signature: widths
    K/2 -> K -> K/2 -> out (``dense0`` .. ``dense3``). The region arguments
    are accepted and unused."""

    def __init__(self, in_features: int, out_features: int,
                 num_kernels: int, basis_func=None, num_regions: int = 1,
                 lower_bounds=(), upper_bounds=(), dimension_ranges=(),
                 activation_idx=(), delta=(), input_scale=None,
                 dtype=torch.float32, device=None,
                 seed: Optional[int] = None, key=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        K = int(num_kernels)
        widths = (int(in_features), K // 2, K, K // 2, int(out_features))
        for i in range(4):
            self._add_dense(f"dense{i}", widths[i], widths[i + 1], kw)
        key = _init_key(seed, key)
        if key is not None:
            self.reset_parameters(key)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(3):
            h = torch.relu(self._dense(f"dense{i}", h))
        return self._dense("dense3", h)


class ClusterWCRBFNet(_RBFModule):
    """Learned-gate variant: a Dense+softmax ``gate`` replaces the geometric
    region indicator, and the logits are returned for the auxiliary
    cluster-classification loss: ``forward`` gives ``(y, logits)``.

    ``input_scale`` makes the kernel distances anisotropic (None: the raw
    isotropic distance). With R = 500 regions the (B, R, K) feature tensor
    is what bounds the batch: chunk probes at 8192 rows.
    """

    def __init__(self, in_features: int, out_features: int,
                 num_kernels: int, basis_func: str, num_regions: int,
                 input_scale: Optional[Sequence[float]] = None,
                 dtype=torch.float32, device=None,
                 seed: Optional[int] = None, key=None):
        super().__init__()
        _check_basis(basis_func)
        self.basis_func = basis_func
        kw = dict(dtype=dtype, device=resolve_device(device))
        R, K, F = int(num_regions), int(num_kernels), int(in_features)
        self._add_core(R, K, F, kw)
        self._add_dense("gate", F, R, kw)
        self._add_dense("head", K, int(out_features), kw)
        self._register_constant("input_scale", input_scale, kw)
        key = _init_key(seed, key)
        if key is not None:
            self.reset_parameters(key)

    def forward(self, x: torch.Tensor):
        logits = self._dense("gate", x)
        weights = torch.softmax(logits, dim=-1)
        feats = self._sharded_features(x, weights)
        return (expert_sum(feats @ self.head_kernel, self.expert_shard)
                + self.head_bias), logits
