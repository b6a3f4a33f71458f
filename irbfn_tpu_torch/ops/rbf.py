"""Fused region-blended RBF forward: the CUDA kernel and its plain version.

Port of ``irbfn_tpu/ops/pallas_rbf.py``. ``wcrbf_forward`` dispatches on
the device of its input:

- a CUDA tensor launches the hand-written Hopper kernel
  ``csrc/rbf_forward.cu`` (built by ``_build.py`` at first use) or raises;
- a CPU tensor runs ``wcrbf_forward_reference``, the plain PyTorch version
  of the same function, which the tests and ``chip_smoke.py`` hold the
  kernel against;
- any other device raises.

``wcrbf_forward.launches`` counts the kernel's launches: a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS

# the kernel's compile-time limits (csrc/rbf_forward.cu)
MAX_FEATURES = 16
_OUT_CHUNK = 16
_TILE_B = 8
_MAX_SMEM_BYTES = 232_448  # a Hopper block's shared-memory ceiling
BASIS_IDS = {name: i for i, name in enumerate(BASIS_FUNCTIONS)}


class RBFOperands(NamedTuple):
    """The kernel's operand set; ``input_scale`` is folded in, so the
    forward takes ``x * input_scale``."""

    centers: torch.Tensor  # (R, K, F)
    inv_sigs: torch.Tensor  # (R, K)
    lb: torch.Tensor  # (R, F) region bounds, +-1e30 on dims not split
    ub: torch.Tensor  # (R, F)
    delta: torch.Tensor  # (F,) gate sharpness
    w: torch.Tensor  # (K, O) shared head | (R, K, O) per-region heads
    b: torch.Tensor  # (O,) | (R, O)
    basis: str  # a BASIS_FUNCTIONS name

    @property
    def per_region(self) -> bool:
        return self.w.ndim == 3


def wcrbf_params_to_kernel(model) -> RBFOperands:
    """The kernel operands of a ``models.wcrbf.WCRBFNet``.

    The per-region head's Dense kernel ``(R*K + R, O)`` becomes ``(R, K, O)``
    heads plus ``(R, O)`` biases, with the global bias folded into each
    region's bias (the normalised gammas sum to 1). The anisotropic
    ``input_scale`` s is folded into the centers and bounds (times s) and
    the gate sharpness (over s).
    """
    centers, lb, ub, delta = (model.centers, model.gate_lb, model.gate_ub,
                              model.gate_delta)
    if model.input_scale is not None:
        s = model.input_scale
        centers, lb, ub, delta = centers * s, lb * s, ub * s, delta / s
    w, b = model.head_kernel, model.head_bias
    if model.head_mode == "per_region":
        R, K = model.num_regions, model.num_kernels
        w, b = w[:R * K].reshape(R, K, -1), w[R * K:] + b[None]
    return RBFOperands(centers.contiguous(), torch.exp(-model.log_sigs), lb,
                       ub, delta, w.contiguous(), b.contiguous(),
                       model.basis_func)


def box_gate(x: torch.Tensor, lb, ub, delta) -> torch.Tensor:
    """Smooth box indicator, ``(B, D) -> (B, R)``:
    ``prod_d s(delta_d (x_d - lb_rd)) s(delta_d (ub_rd - x_d))`` with
    ``s(t) = (tanh(t) + 1)/2``; lb/ub (R, D), delta (D,)."""
    lo = (torch.tanh(delta * (x[:, None, :] - lb)) + 1.0) * 0.5
    hi = (torch.tanh(delta * (ub - x[:, None, :])) + 1.0) * 0.5
    return torch.prod(lo * hi, dim=-1)


def center_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``||x_b - c_rk||``, ``(B, F), (R, K, F) -> (B, R, K)``, with d^2 summed
    directly as ``sum_f (x_f - c_f)^2``: exact in f32, where the
    ``x^2 - 2xc + c^2`` form cancels when ``||x - c|| << ||x||``."""
    sq = torch.zeros(x.shape[:1] + c.shape[:2], dtype=x.dtype,
                     device=x.device)
    for f in range(x.shape[-1]):
        df = x[:, f, None, None] - c[None, :, :, f]
        sq = sq + df * df
    return torch.sqrt(torch.clamp(sq, min=1e-30))


def wcrbf_forward_reference(x: torch.Tensor, ops: RBFOperands) -> torch.Tensor:
    """Plain PyTorch forward, in ``x``'s dtype: materialises the (B, R, K)
    basis tensor that the kernel keeps on chip."""
    c, inv_sigs, lb, ub, delta, w, b = (t.to(x.dtype) for t in ops[:7])
    gamma = box_gate(x, lb, ub, delta)  # (B, R)
    if ops.per_region:
        gamma = gamma / (gamma.sum(-1, keepdim=True) + 1e-9)
    d = center_distances(x, c) * inv_sigs
    gphi = gamma[:, :, None] * BASIS_FUNCTIONS[ops.basis](d)  # (B, R, K)
    if ops.per_region:
        return (gphi.reshape(x.shape[0], -1) @ w.reshape(-1, w.shape[-1])
                + gamma @ b)
    return gphi.sum(1) @ w + b


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from irbfn_tpu_torch.ops._build import build

    res = build("rbf_forward")
    lib = ctypes.CDLL(str(res.path))
    fn = lib.rbf_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.build_result = res
    return lib


def build_kernel():
    """Build (or find) and load the kernel's library; returns its
    ``_build.BuildResult``."""
    return _library().build_result


def smem_bytes(R: int, K: int, F: int, O: int) -> int:
    """Dynamic shared memory one block of the kernel takes."""
    return 4 * (_TILE_B * F + _TILE_B * R + F * K + K + min(O, _OUT_CHUNK) * K)


def _launch(x: torch.Tensor, ops: RBFOperands) -> torch.Tensor:
    tensors = (x,) + tuple(ops[:7])
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("the CUDA RBF kernel takes f32 tensors on one "
                             f"device; got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA RBF kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA RBF kernel has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")
    B, F = x.shape
    R, K, Fc = ops.centers.shape
    O = ops.w.shape[-1]
    head = (R, K, O) if ops.per_region else (K, O)
    bias = (R, O) if ops.per_region else (O,)
    if (Fc != F or ops.inv_sigs.shape != (R, K) or ops.lb.shape != (R, F)
            or ops.ub.shape != (R, F) or ops.delta.shape != (F,)
            or ops.w.shape != head or ops.b.shape != bias):
        raise ValueError("RBF operand shapes do not agree: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if F > MAX_FEATURES:
        raise ValueError(f"the CUDA RBF kernel takes at most {MAX_FEATURES} "
                         f"features, got {F}")
    if smem_bytes(R, K, F, O) > _MAX_SMEM_BYTES:
        raise ValueError(f"K={K}, F={F} needs {smem_bytes(R, K, F, O)} bytes"
                         " of shared memory per block, over the card's "
                         f"{_MAX_SMEM_BYTES}")
    if ops.basis not in BASIS_IDS:
        raise ValueError(f"the CUDA RBF kernel has no basis {ops.basis!r}")
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rbf_forward_f32(
            *(t.data_ptr() for t in tensors), out.data_ptr(), B, R, K, F, O,
            int(ops.per_region), BASIS_IDS[ops.basis], stream)
    if rc != 0:
        raise RuntimeError(f"rbf_forward kernel launch failed: CUDA error "
                           f"{rc}")
    wcrbf_forward.launches += 1
    return out


def wcrbf_forward(x: torch.Tensor, ops: RBFOperands) -> torch.Tensor:
    """Fused WCRBF forward, ``(B, F) -> (B, O)``; ``x`` is pre-scaled by the
    model's ``input_scale`` (see ``wcrbf_params_to_kernel``).

    CUDA tensors launch the kernel (f32 only) or raise; CPU tensors take
    the plain version; other devices raise.
    """
    if x.device.type == "cuda":
        return _launch(x, ops)
    if x.device.type == "cpu":
        return wcrbf_forward_reference(x, ops)
    raise ValueError(f"wcrbf_forward runs on CUDA or CPU tensors, not "
                     f"{x.device.type}")


wcrbf_forward.launches = 0
