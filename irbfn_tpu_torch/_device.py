"""Where the port's entry points put their tensors.

Every entry point of the port takes ``device=None`` and resolves it here:
``None`` means the card, ``torch.device("cuda")``. There is no fallback to
the CPU: without a GPU the first CUDA tensor raises torch's own error. A
caller that wants the CPU (the parity tests do) passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else -> itself."""
    return torch.device("cuda") if device is None else torch.device(device)
