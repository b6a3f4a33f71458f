"""What a ``--trace 1`` run reads: synchronised spans around the calls into
the program's layers, and a ``torch.profiler`` trace of a short stretch.

A span is timed on the host's clock between two device synchronisations, so
it holds the layer's whole work. Spans are kept in memory by name. The
profiler's trace gives the device's busy time (the union of its kernels'
intervals), the kernels by name, the host's kernel launches, and the gaps in
which the device was idle, named by what the host was doing then.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


class Spans:
    """Durations by name; ``span(name)`` times a block between two device
    synchronisations (none when ``enabled`` is false)."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.times = defaultdict(list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self._sync()
        self.times[name].append(time.perf_counter() - t0)


def profile(device):
    """A profiler over the host and, on the card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _is_device(e) -> bool:
    """A kernel, copy or fill on the card. Annotations appear among the
    device rows too, spanning the work they label: the benchmark's spans
    and ``torch.distributed``'s ``nccl:<collective>`` records; counting them
    would count their kernels twice."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("bench.", "nccl:")))


def _union(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def summarize(prof, window_s: float, units: int) -> dict:
    """Reduce a trace of ``units`` units of work over ``window_s`` seconds:
    ``busy_s``; ``kernels`` {name: [seconds, count]}; ``launches``;
    ``top_ops`` and ``idle_gaps``, the ten longest of each as
    [name, seconds]; ``units`` and ``window_s``."""
    events = list(prof.events())
    dev = [e for e in events if _is_device(e)]
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    kernels = defaultdict(lambda: [0.0, 0])
    for e in dev:
        k = kernels[e.name]
        k[0] += (e.time_range.end - e.time_range.start) * 1e-6
        k[1] += 1
    host = [e for e in events if not _is_device(e)]
    launches = sum(1 for e in host if e.name in LAUNCH_CALLS)
    return dict(busy_s=_union(iv) * 1e-6, window_s=window_s, units=units,
                kernels=dict(kernels), launches=launches,
                top_ops=[[n, v[0]] for n, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1][0])[:10]],
                idle_gaps=_idle_gaps(iv, host))


def _idle_gaps(intervals, host, n: int = 10, min_us: float = 2.0):
    """The device's idle gaps, summed by the innermost host operation that
    ran at each gap's midpoint, leaving out the CUDA runtime's own calls
    (prefixed by the benchmark's span around it); the ``n`` largest sums as
    [name, seconds]."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s - end > min_us:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in host if not e.name.startswith("cu"))
    spans = [o for o in ops if o[2].startswith("bench.")]
    op_starts = [o[0] for o in ops]
    span_starts = [o[0] for o in spans]
    totals = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = "host (no operation)"
        # the latest-starting operation that still runs at the midpoint
        i = bisect.bisect_right(op_starts, mid)
        for s, e, op in reversed(ops[max(0, i - 64):i]):
            if e >= mid:
                name = op
                break
        j = bisect.bisect_right(span_starts, mid)
        for s, e, op in reversed(spans[max(0, j - 8):j]):
            if e >= mid:
                if op != name:
                    name = f"{op}/{name}"
                break
        totals[name] += (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]


def kernel_seconds(summary: dict, *needles: str) -> float | None:
    """Device seconds of the kernels whose name holds any of ``needles``;
    None when no such kernel ran."""
    hits = [v[0] for k, v in summary["kernels"].items()
            if any(s in k for s in needles)]
    return sum(hits) if hits else None
