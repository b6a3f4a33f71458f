"""What every driver does the same way."""

from __future__ import annotations

import gc
import time

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now(device) -> float:
    """The host's clock once the device has finished its work."""
    sync(device)
    return time.perf_counter()


def device_kind(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device):
    """Return the program's freed memory to the card before a reference
    runs beside what is left."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sample(n: int, k: int, gen) -> list:
    """``k`` of ``range(n)`` drawn by ``gen`` (all of them when k >= n),
    sorted, with the last always in."""
    if k >= n:
        return list(range(n))
    pick = set(gen.choice(n - 1, k - 1, replace=False).tolist())
    return sorted(pick | {n - 1})
