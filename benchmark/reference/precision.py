"""Working precisions of the plain references.

``"f64"`` is the reference itself. The controls are the next precision
down from the configurations' float32 with TF32 off: ``"tf32"``, float32
arithmetic whose matrix products take their operands rounded to TF32 (10
mantissa bits, round to nearest even) and accumulate in float32, as a
tensor-core product with TF32 enabled does; and ``"bf16"`` for float32
work that is no matrix product (bfloat16 arithmetic; a product in it still
goes through TF32). The rounding is explicit, so a control means the same
on every device and whatever cuBLAS chooses for a small product.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f64", "tf32", "bf16")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    return {"f64": torch.float64, "tf32": torch.float32,
            "bf16": torch.bfloat16}[precision]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits, to nearest even."""
    if t.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {t.dtype}")
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    rounded = (i + 0x0FFF + lsb) & -8192
    # leave inf and nan alone
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``: exact in float64, or with TF32 operands."""
    if precision in ("tf32", "bf16"):
        out = round_tf32(a.float()) @ round_tf32(b.float())
        return out.to(a.dtype)
    return a @ b


def no_tf32():
    """Turn off TF32 in torch's own products, so that a float32 or float64
    product means what it says (the control rounds explicitly)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
