"""The port's own spans (``irbfn_tpu_torch/utils/spans.py``) read beside the
device's trace of a ``--trace 1`` run: which of the pipeline's steps the
host was in while the card sat idle, how long rank 0 waited for the last
rank at each gather, and how much of the set-up the port's calls took.

A rank's view (``rank_view``) holds its spans twice: as the port recorded
them on CLOCK_MONOTONIC (``setup``: the set-up's, ``window``: the profiled
stretch's), and as the profiler saw them (``marks``, on the trace's clock,
beside the device's kernels, ``device``). The two clocks are related only
through the spans found in both: a rank's offset is the median, over its
spans, of the profiler's start less the port's start (``offset_ns``), the
two lists of spans lined up by their names in start order, so that spans
the port recorded outside the profiled stretch pair with nothing. Nothing
is assumed about the profiler's base.

The readers (``pipeline_idle_share``, ``gather_wait_ms``,
``setup_program_s``) take the per-layer readers' ``layer`` dict with the
ranks' views under ``"program"`` (rank 0 first), and return None where
there is nothing to read.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

import torch

from benchmark.trace import _is_device

# the port's span names begin with their layer (its utils/spans.py)
PREFIXES = ("lattice.", "goal.", "ops.")
PIPELINE = "lattice."
GATHER = "lattice.gather"
NCCL = ("ncclDevKernel", "ncclKernel")
MIN_GAP_US = 2.0  # trace.py's least idle gap


def begin() -> None:
    """Turn the port's tracing on, with no records."""
    from irbfn_tpu_torch.utils import spans

    spans.enable(True)
    spans.reset()


def take() -> list:
    """The port's records so far, then none: ``records()`` and
    ``reset()``."""
    from irbfn_tpu_torch.utils import spans

    out = spans.records()
    spans.reset()
    return out


def rank_view(prof, setup: list, window: list) -> dict:
    """What one rank's trace says of the port's spans: ``device``, its
    kernels as [start_us, end_us, is_nccl] in start order; ``marks``, the
    port's spans as the profiler saw them, [name, start_us, end_us];
    ``setup`` and ``window``, the port's own records."""
    device, marks = [], []
    for e in prof.events():
        name = e.name
        if name.startswith(PREFIXES):
            if e.device_type == torch.autograd.DeviceType.CPU:
                marks.append([name, e.time_range.start, e.time_range.end])
        elif _is_device(e):
            device.append([e.time_range.start, e.time_range.end,
                           name.startswith(NCCL)])
    device.sort()
    marks.sort(key=lambda m: m[1])
    return dict(device=device, marks=marks, setup=list(setup),
                window=list(window))


def _line_up(a: list, b: list) -> int:
    """The shift k that lines ``b[j]`` up with ``a[j + k]`` where the most
    names agree (the smallest such k)."""
    best, best_k = -1, 0
    for k in range(-len(b) + 1, len(a)):
        same = sum(1 for j in range(max(0, -k), min(len(b), len(a) - k))
                   if a[j + k] == b[j])
        if same > best:
            best, best_k = same, k
    return best_k


def offset_ns(view: dict) -> float | None:
    """The profiler's clock less CLOCK_MONOTONIC on this rank, in ns: the
    median over the spans found in both. The port's records and the
    profiler's marks, each in start order, are lined up where the most
    names agree (``_line_up``), and only spans whose names agree there are
    paired: a span recorded before the profiler started, or after it
    stopped, shifts no pair."""
    mine = sorted(view["window"], key=lambda r: r["start_ns"])
    marks = view["marks"]
    k = _line_up([r["name"] for r in mine], [m[0] for m in marks])
    diffs = [1e3 * m[1] - mine[j + k]["start_ns"]
             for j, m in enumerate(marks)
             if 0 <= j + k < len(mine) and mine[j + k]["name"] == m[0]]
    return statistics.median(diffs) if diffs else None


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(device: list, min_us: float = MIN_GAP_US) -> list:
    """The device's idle gaps longer than ``min_us`` between its first and
    last kernel, as trace.py finds them: [start_us, end_us]."""
    out, end = [], None
    for s, e, _ in device:
        if end is not None and s - end > min_us:
            out.append([end, s])
        end = e if end is None else max(end, e)
    return out


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def pipeline_idle_us(view: dict) -> float:
    """Microseconds in which the device was idle (``gaps``) while the host
    was inside one of the pipeline's spans (``lattice.*``)."""
    inside = _union([(s, e) for n, s, e in view["marks"]
                     if n.startswith(PIPELINE)])
    return _overlap(gaps(view["device"]), inside)


def idle_by_span(view: dict) -> dict:
    """{span: seconds} of the device's idle gaps, each piece put down to
    the innermost of the port's spans the host was in (the latest opened
    of those still open), ``"outside"`` where it was in none."""
    marks = view["marks"]
    starts = [m[1] for m in marks]
    out = defaultdict(float)
    for g0, g1 in gaps(view["device"]):
        cuts = {g0, g1}
        open_ = [m for m in marks[:bisect.bisect_right(starts, g1)]
                 if m[2] > g0]
        for _, s, e in open_:
            cuts.update(t for t in (s, e) if g0 < t < g1)
        cuts = sorted(cuts)
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [m for m in open_ if m[1] <= mid < m[2]]
            name = max(inner, key=lambda m: m[1])[0] if inner else "outside"
            out[name] += (b - a) * 1e-6
    return dict(out)


def arrivals(view: dict) -> dict:
    """{(family, chunk): CLOCK_MONOTONIC ns} at which this rank arrived at
    each of its gathers: the later of its ``lattice.gather`` span opening
    and the end of its own last kernel before that gather's first NCCL
    kernel. The NCCL kernels go to the gathers in order, the same number
    to each; without them (gloo on the CPU) the span's opening alone."""
    gathers = [r for r in view["window"] if r["name"] == GATHER]
    if not gathers:
        return {}
    off = offset_ns(view)
    nccl = [d for d in view["device"] if d[2]]
    per = len(nccl) // len(gathers)
    use_device = (off is not None and per > 0
                  and len(nccl) == per * len(gathers))
    other_ends = sorted(d[1] for d in view["device"] if not d[2])
    out = {}
    for j, g in enumerate(gathers):
        t = float(g["start_ns"])
        if use_device:
            first = nccl[j * per][0]
            k = bisect.bisect_right(other_ends, first)
            if k:
                t = max(t, 1e3 * other_ends[k - 1] - off)
        out[g["family"], g["chunk"]] = t
    return out


def gather_waits(views: list) -> dict:
    """{family: ns} rank 0 waited at its gathers: for each chunk, the latest
    rank's arrival less rank 0's, summed over the family's chunks."""
    arr = [arrivals(v) for v in views]
    keys = set(arr[0]).intersection(*arr[1:])
    out = defaultdict(float)
    for key in keys:
        out[key[0]] += max(a[key] for a in arr) - arr[0][key]
    return dict(out)


def setup_seconds(records: list) -> float:
    """Seconds covered by the port's top-level spans among ``records``."""
    return 1e-9 * sum(e - s for s, e in _union(
        (r["start_ns"], r["end_ns"]) for r in records
        if r["parent"] == -1 and r["end_ns"] is not None))


def pipeline_idle_share(layer):
    """The share of rank 0's traced wall time in which no kernel ran while
    its host was inside a ``lattice.*`` span, in %."""
    views, tr = layer.get("program"), layer.get("trace")
    if not views or not tr or not views[0]["marks"] or not views[0][
            "device"]:
        return None
    return 100.0 * 1e-6 * pipeline_idle_us(views[0]) / tr["window_s"]


def gather_wait_ms(layer):
    """How long rank 0 waited for the last rank at the gathers of a traced
    family (``gather_waits``), averaged over the families, in ms."""
    views = layer.get("program")
    if not views or len(views) < 2:
        return None
    waits = gather_waits(views)
    return 1e-6 * statistics.mean(waits.values()) if waits else None


def setup_program_s(layer):
    """Seconds of rank 0's set-up covered by the port's top-level spans
    (``ops.library``, the set-up's ``lattice.family``)."""
    views = layer.get("program")
    if not views or not views[0]["setup"]:
        return None
    return setup_seconds(views[0]["setup"])
