"""The f32 FMA-ceiling probe of the NMPC roofline.

A measuring probe, not the counterpart of a TPU kernel (so it is not in
``ops.KERNELS``): ``fma_chain(x, repeats)`` applies ``y <- y * A + B``
``STEPS * repeats`` times to every element of an f32 tensor.

- a CUDA tensor launches ``csrc/fma_ceiling.cu`` (one fused pass: each
  thread a dependent chain of fused multiply-adds in registers; built by
  ``ops/_build.py`` at the first launch) or raises;
- a CPU tensor takes the plain version, ``fma_chain_reference``: the same
  chain as ``2 * STEPS * repeats`` tensor operations.

The counter ``ops.fma.launches`` (``utils/spans.py``) counts the kernel's
launches. The plain chain rounds twice a step where the kernel's FMA rounds
once: the two agree to ~1e-6 relative after 64 steps, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from irbfn_tpu_torch.utils import spans

STEPS = 64  # FMAs of one chain (the kernel's kSteps)
A, B = 1.000001, 1e-6  # the JAX package's chain constants


def fma_chain_reference(x: torch.Tensor, repeats: int = 1) -> torch.Tensor:
    """The chain in plain PyTorch: ``2 * STEPS * repeats`` elementwise
    operations, each a pass over ``x``'s memory."""
    y = x
    for _ in range(STEPS * repeats):
        y = y * A + B
    return y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from irbfn_tpu_torch.ops._build import build

    with spans.span("ops.library", label="fma_ceiling"):
        res = build("fma_ceiling")
        lib = ctypes.CDLL(str(res.path))
    lib.fma_chain_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p]
    lib.fma_chain_f32.restype = ctypes.c_int
    lib.fma_chain_steps.argtypes = []
    lib.fma_chain_steps.restype = ctypes.c_int
    if lib.fma_chain_steps() != STEPS:
        raise RuntimeError(f"csrc/fma_ceiling.cu chains "
                           f"{lib.fma_chain_steps()} FMAs, not {STEPS}")
    lib.build_result = res
    return lib


def build_kernel():
    """Build (or find) and load the probe's library; returns its
    ``_build.BuildResult``."""
    return _library().build_result


def fma_chain(x: torch.Tensor, repeats: int = 1) -> torch.Tensor:
    """``STEPS * repeats`` multiply-adds on every element of ``x`` (f32):
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fma_chain_reference(x, repeats)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain runs on CUDA or CPU tensors, not "
                         f"{x.device.type}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the FMA kernel takes a contiguous f32 tensor")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _library().fma_chain_f32(
            x.data_ptr(), y.data_ptr(), x.numel(), int(repeats), A, B,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fma_chain kernel launch failed: CUDA error {rc}")
    spans.count("ops.fma.launches")
    return y
