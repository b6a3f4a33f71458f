"""Fused region-blended RBF forward: the CUDA kernel and its plain version.

Port of ``irbfn_tpu/ops/pallas_rbf.py``. ``wcrbf_forward`` dispatches on
the device of its input:

- a CUDA tensor launches the hand-written Hopper kernel
  ``csrc/rbf_forward.cu`` (built by ``_build.py`` at first use) or raises;
- a CPU tensor runs ``wcrbf_forward_reference``, the plain PyTorch version
  of the same function, which the tests and ``chip_smoke.py`` hold the
  kernel against;
- any other device raises.

``wcrbf_forward.launches`` counts the forwards that went through the kernel
(each is two launches: the region groups' partial sums, then their ordered
sum): a run can show that its main path went through the kernel.

``partial=True`` is the forward of one shard of the regions, for a net whose
region axis is split over the ranks of an expert group
(``models/wcrbf.py``): ``(B, O + 1)``, the undivided region sums and the
shard's gate sum, which the ranks add up (one ``all_reduce``) before
``finish_partial`` divides, as the default mode does within one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS

# the kernel's compile-time limits (csrc/rbf_forward.cu)
MAX_FEATURES = 16
_OUT_CHUNK = 16  # outputs per block; a wider head takes several chunks
_OUT_WIDTHS = (4, 12, 16)  # accumulator widths the kernel is built for
_TILE_B = 32  # batch rows per block
_K_ALIGN = 32  # centers are padded to a multiple of a warp's lanes
_MAX_SMEM_BYTES = 232_448  # a Hopper block's shared-memory ceiling
BASIS_IDS = {name: i for i, name in enumerate(BASIS_FUNCTIONS)}


class RBFOperands(NamedTuple):
    """The forward's operand set; ``input_scale`` is folded in, so the
    forward takes ``x * input_scale``. The first seven are the plain layout
    (``wcrbf_forward_reference``); ``c_packed`` and ``w_packed`` hold the
    same centers, widths and heads as the kernel stages them
    (``pack_operands``), or None where the kernel does not serve the shape."""

    centers: torch.Tensor  # (R, K, F)
    inv_sigs: torch.Tensor  # (R, K)
    lb: torch.Tensor  # (R, F) region bounds, +-1e30 on dims not split
    ub: torch.Tensor  # (R, F)
    delta: torch.Tensor  # (F,) gate sharpness
    w: torch.Tensor  # (K, O) shared head | (R, K, O) per-region heads
    b: torch.Tensor  # (O,) | (R, O)
    basis: str  # a BASIS_FUNCTIONS name
    c_packed: Optional[torch.Tensor] = None  # (R, FP + 1, Kp)
    w_packed: Optional[torch.Tensor] = None  # (O, Kp) | (R, O, Kp)

    @property
    def per_region(self) -> bool:
        return self.w.ndim == 3


def packed_features(F: int) -> int:
    """Feature rows of a packed region tile: 8 or 16, the widths the kernel
    unrolls its distance loop for."""
    return 8 if F <= 8 else 16


def pack_operands(centers, inv_sigs, w):
    """The kernel's layout of centers (R, K, F), inv_sigs (R, K) and heads
    w (K, O) | (R, K, O): ``c_packed`` (R, FP + 1, Kp) holds, per region,
    the centers transposed (feature rows f < F, zero rows up to
    FP = packed_features(F)) and the widths as the last row; ``w_packed``
    (O, Kp) | (R, O, Kp) the heads transposed. Kp is K rounded up to
    _K_ALIGN with zeros, so every row is a 128-byte multiple and a region's
    tile is one contiguous 16-byte-aligned run per tensor. Padded centers
    carry zero width and zero head weight: they add exactly zero."""
    R, K, F = centers.shape
    FP = packed_features(F)
    Kp = -(-K // _K_ALIGN) * _K_ALIGN
    c_packed = centers.new_zeros((R, FP + 1, Kp))
    c_packed[:, :F, :K] = centers.transpose(1, 2)
    c_packed[:, FP, :K] = inv_sigs
    w_packed = w.new_zeros(w.shape[:-2] + (w.shape[-1], Kp))
    w_packed[..., :K] = w.transpose(-1, -2)
    return c_packed, w_packed


def unpack_operands(c_packed, w_packed, K: int, F: int):
    """``pack_operands`` undone: (centers, inv_sigs, w) in the plain layout."""
    FP = c_packed.shape[1] - 1
    return (c_packed[:, :F, :K].transpose(1, 2).contiguous(),
            c_packed[:, FP, :K].contiguous(),
            w_packed[..., :K].transpose(-1, -2).contiguous())


def wcrbf_params_to_kernel(model) -> RBFOperands:
    """The forward's operands of a ``models.wcrbf.WCRBFNet``, both layouts.

    The per-region head's Dense kernel ``(R*K + R, O)`` becomes ``(R, K, O)``
    heads plus ``(R, O)`` biases, with the global bias folded into each
    region's bias (the normalised gammas sum to 1). The anisotropic
    ``input_scale`` s is folded into the centers and bounds (times s) and
    the gate sharpness (over s). Call it once per model and set of weights
    (``WCRBFNet.kernel_operands`` keeps the result): the packing costs a few
    tensor operations that a forward should not repeat. A model whose
    regions are sharded (``parallel/mesh.py:shard_params``) gives the
    operands of its own regions ``model.region_range()``: their centers,
    bounds and heads, for the partial mode.
    """
    centers, lb, ub, delta = (model.centers, model.gate_lb, model.gate_ub,
                              model.gate_delta)
    if model.input_scale is not None:
        s = model.input_scale
        centers, lb, ub, delta = centers * s, lb * s, ub * s, delta / s
    r0, r1 = model.region_range()  # every region, unless sharded
    lb, ub = lb[r0:r1], ub[r0:r1]
    w, b = model.head_kernel, model.head_bias
    if model.head_mode == "per_region":
        R, K = model.num_regions, model.num_kernels
        w, b = (w[:R * K].reshape(R, K, -1)[r0:r1],
                (w[R * K:] + b[None])[r0:r1])
    centers, w = centers.contiguous(), w.contiguous()
    inv_sigs = torch.exp(-model.log_sigs)
    packed = (pack_operands(centers, inv_sigs, w)
              if centers.shape[-1] <= MAX_FEATURES else (None, None))
    return RBFOperands(centers, inv_sigs, lb.contiguous(), ub.contiguous(),
                       delta.contiguous(), w, b.contiguous(),
                       model.basis_func, *packed)


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


def wcrbf_forward_reference(x: torch.Tensor, ops: RBFOperands,
                            partial: bool = False) -> torch.Tensor:
    """Plain PyTorch forward, in ``x``'s dtype: materialises the (B, R, K)
    basis tensor that the kernel keeps on chip. ``partial``: the kernel's
    partial mode, ``(B, O + 1)`` (module docstring)."""
    c, inv_sigs, lb, ub, delta, w, b = (t.to(x.dtype) for t in ops[:7])
    gamma = box_gate(x, lb, ub, delta)  # (B, R)
    if partial:
        gphi = gamma[:, :, None] * BASIS_FUNCTIONS[ops.basis](
            center_distances(x, c) * inv_sigs)
        num = (gphi.reshape(x.shape[0], -1) @ w.reshape(-1, w.shape[-1])
               + gamma @ b if ops.per_region else gphi.sum(1) @ w)
        return torch.cat([num, gamma.sum(-1, keepdim=True)], dim=-1)
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
    for fn in (lib.rbf_forward_f32, lib.rbf_forward_partial_f32):
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rbf_empty_launch.argtypes = [ctypes.c_void_p]
    lib.rbf_empty_launch.restype = ctypes.c_int
    lib.build_result = res
    return lib


def build_kernel():
    """Build (or find) and load the kernel's library; returns its
    ``_build.BuildResult``."""
    return _library().build_result


def empty_launch() -> None:
    """Launch a kernel that does nothing on the current stream of the
    current CUDA device: what a launch costs by itself, the floor that the
    time tables set under a forward of two launches."""
    rc = _library().rbf_empty_launch(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(K: int, F: int, O: int, regions: int, stages: int) -> int:
    """Dynamic shared memory of one block: ``stages`` region tiles (centers,
    widths, the head rows and the biases of one output chunk) and the
    block's gates."""
    Kp = -(-K // _K_ALIGN) * _K_ALIGN
    oc = next(n for n in _OUT_WIDTHS if n >= min(O, _OUT_CHUNK))
    return 4 * (stages * ((packed_features(F) + 1 + oc) * Kp + _OUT_CHUNK)
                + _TILE_B * regions)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, R: int, K: int, F: int, O: int, sms: int):
    """(regions per block, stages) of one forward on a card of ``sms`` SMs.

    The grid is ceil(B / _TILE_B) batch tiles times ceil(R / regions) region
    groups; the regions per block are chosen so that the grid is about two
    blocks per SM (what the registers keep resident), and evened out over
    the groups. A block that loops over several regions double-buffers
    their tiles where two fit under the card's ceiling."""
    tiles = -(-B // _TILE_B)
    regions = min(R, max(1, round(R * tiles / (2 * sms))))
    regions = -(-R // -(-R // regions))  # even groups: 16 in 5s -> 4 x 4
    stages = 2 if regions > 1 else 1
    if smem_bytes(K, F, O, regions, stages) > _MAX_SMEM_BYTES:
        stages = 1
    need = smem_bytes(K, F, O, regions, stages)
    if need > _MAX_SMEM_BYTES:
        raise ValueError(f"K={K}, F={F}, O={O} needs {need} bytes of shared "
                         "memory per block, over the card's "
                         f"{_MAX_SMEM_BYTES}")
    return regions, stages


class _Checked(NamedTuple):
    """What a launch needs of an operand set that passed ``_check``."""

    ops: RBFOperands  # kept alive, so that its id stays its own
    device: torch.device
    pointers: tuple  # c_packed, lb, ub, delta, w_packed, b
    dims: tuple  # R, K, Kp, F, O
    tail: tuple  # per_region, basis id
    requires_grad: bool  # an operand does: launch under no_grad only


_CHECKED: dict = {}  # id(ops) -> _Checked, the last few operand sets
_CHECKED_MAX = 16


def _check(ops: RBFOperands) -> _Checked:
    """Raise on operands the kernel does not take. An operand set is checked
    once: the planners launch the same one at every control step."""
    R, K, F = ops.centers.shape
    O = ops.w.shape[-1]
    if F > MAX_FEATURES:
        raise ValueError(f"the CUDA RBF kernel takes at most {MAX_FEATURES} "
                         f"features, got {F}")
    if ops.c_packed is None or ops.w_packed is None:
        raise ValueError("the CUDA RBF kernel reads the packed operands: "
                         "build RBFOperands with wcrbf_params_to_kernel or "
                         "pack_operands")
    tensors = (ops.c_packed, ops.lb, ops.ub, ops.delta, ops.w_packed, ops.b)
    device = ops.c_packed.device
    for t in tensors:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError("the CUDA RBF kernel takes f32 tensors on one "
                             f"device; got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA RBF kernel takes contiguous tensors")
    Kp = ops.c_packed.shape[-1]
    head = (R, O, Kp) if ops.per_region else (O, Kp)
    bias = (R, O) if ops.per_region else (O,)
    if (ops.lb.shape != (R, F) or ops.ub.shape != (R, F)
            or ops.delta.shape != (F,) or ops.b.shape != bias
            or ops.c_packed.shape != (R, packed_features(F) + 1, Kp)
            or ops.w_packed.shape != head or Kp % _K_ALIGN or Kp < K):
        raise ValueError("RBF operand shapes do not agree: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if ops.c_packed.data_ptr() % 16 or ops.w_packed.data_ptr() % 16:
        raise ValueError("the CUDA RBF kernel copies the packed operands 16 "
                         "bytes at a time: their data must be 16-byte "
                         "aligned")
    if ops.basis not in BASIS_IDS:
        raise ValueError(f"the CUDA RBF kernel has no basis {ops.basis!r}")
    return _Checked(ops, device, tuple(t.data_ptr() for t in tensors),
                    (R, K, Kp, F, O),
                    (int(ops.per_region), BASIS_IDS[ops.basis]),
                    any(t.requires_grad for t in tensors))


def _launch(x: torch.Tensor, ops: RBFOperands,
            partial: bool = False) -> torch.Tensor:
    ok = _CHECKED.get(id(ops))
    if ok is None or ok.ops is not ops:
        ok = _check(ops)
        if len(_CHECKED) >= _CHECKED_MAX:
            _CHECKED.pop(next(iter(_CHECKED)))
        _CHECKED[id(ops)] = ok
    if x.device != ok.device or x.dtype != torch.float32:
        raise ValueError("the CUDA RBF kernel takes f32 tensors on one "
                         f"device; got {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("the CUDA RBF kernel takes contiguous tensors")
    if torch.is_grad_enabled() and (x.requires_grad or ok.requires_grad):
        raise RuntimeError("the CUDA RBF kernel has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")
    R, K, Kp, F, O = ok.dims
    if x.ndim != 2 or x.shape[1] != F:
        raise ValueError("RBF operand shapes do not agree: x "
                         f"{tuple(x.shape)}, centers {(R, K, F)}")
    B = x.shape[0]
    out = torch.empty((B, O + 1 if partial else O), dtype=torch.float32,
                      device=x.device)
    if B == 0:
        return out
    index = x.device.index
    current = torch.cuda.current_device()
    if index is None:
        index = current
    regions, stages = launch_plan(B, R, K, F, O, _sm_count(index))
    parts = -(-R // regions)
    # the region groups' partial sums (parts, B, O), then the gates (R, B)
    scratch = torch.empty(parts * B * O + R * B, dtype=torch.float32,
                          device=x.device)
    c_packed, lb, ub, delta, w_packed, b = ok.pointers
    lib = _library()
    if index != current:
        torch.cuda.set_device(index)
    try:
        forward = (lib.rbf_forward_partial_f32 if partial
                   else lib.rbf_forward_f32)
        rc = forward(
            x.data_ptr(), c_packed, lb, ub, delta, w_packed, b,
            out.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * parts * B * O, B, R, Kp, F, O, regions,
            stages, *ok.tail, torch.cuda.current_stream(index).cuda_stream)
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if rc != 0:
        raise RuntimeError(f"rbf_forward kernel launch failed: CUDA error "
                           f"{rc}")
    wcrbf_forward.launches += 1
    return out


def wcrbf_forward(x: torch.Tensor, ops: RBFOperands,
                  partial: bool = False) -> torch.Tensor:
    """Fused WCRBF forward, ``(B, F) -> (B, O)``; ``x`` is pre-scaled by the
    model's ``input_scale`` (see ``wcrbf_params_to_kernel``). ``partial``:
    the forward of a shard of the regions, ``(B, O + 1)`` (module
    docstring; ``finish_partial`` ends it).

    CUDA tensors launch the kernel (f32 only) or raise; CPU tensors take
    the plain version; other devices raise.
    """
    if x.device.type == "cuda":
        return _launch(x, ops, partial)
    if x.device.type == "cpu":
        return wcrbf_forward_reference(x, ops, partial)
    raise ValueError(f"wcrbf_forward runs on CUDA or CPU tensors, not "
                     f"{x.device.type}")


wcrbf_forward.launches = 0


def finish_partial(part: torch.Tensor, ops: RBFOperands) -> torch.Tensor:
    """The sum over every shard of the partial forwards, ``(B, O + 1)`` ->
    ``(B, O)``: divided by the gate sum (per-region heads, as the kernel's
    own last launch divides) or plus the shared head's bias."""
    O = part.shape[-1] - 1
    if ops.per_region:
        return part[:, :O] / (part[:, O:] + 1e-9)
    return part[:, :O] + ops.b.to(part.dtype)
