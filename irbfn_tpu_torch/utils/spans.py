"""The port's spans and counters: what the program was doing, and how much
of it.

- ``span(name, chunk=None, label=None)`` is a context manager around one
  step of work. While tracing is off (the default) it returns one shared object
  that does nothing, after a single flag check: it reads no clock, opens no
  profiler range and records nothing. While tracing is on (``enable(True)``)
  it opens ``torch.profiler.record_function(name)``, so that an active
  profiler shows the span beside the device's kernels on the trace's own
  clock, and it keeps a record in memory: the name, start and end from
  ``time.monotonic_ns()`` (CLOCK_MONOTONIC, which every process of one host
  shares), the index of the enclosing span (``parent``, -1 for none), the
  lattice family it belongs to (``family``: the ordinal of the enclosing
  ``lattice.family`` span since the last ``reset()``), its chunk (``chunk``:
  its own, else its parent's) and ``label`` (a kernel's or variant's name).
  A span never waits for the device, so its end is when the host has
  enqueued its work. ``records()`` returns the records, ``reset()`` clears
  them between traced stretches, with no span open; the program never
  writes them out.
- ``count(name, n=1)`` adds to a counter that is always on;
  ``counters()`` returns a snapshot, ``since(before, prefix)`` what moved
  after one.

Span names begin with their layer (``PREFIXES``): ``lattice.``
(``parallel/datagen.py``), ``goal.`` (``solvers/goal_mpc.py``), ``ops.``
(``ops/``: ``ops.library`` around a kernel's build and load, ``ops.admm``
and ``ops.rbf`` around each launch, labelled with the ADMM variant and the
RBF forward's ``"<regions>x<stages>"`` plan; counters ``ops.admm.family``,
``ops.admm.lane``, and ``ops.rbf.forwards``, ``ops.rbf.rows`` (batch rows)
and ``ops.rbf.region_groups`` (the grid's region groups) a forward);
counters also ``nmpc.`` (``solvers/nmpc.py``). ``bench.`` and ``nccl:``
belong to the benchmark and to ``torch.distributed``.

Spans nest within a thread; each thread keeps its own stack of open spans.
Nothing reads an environment variable: a caller turns tracing on.
"""

from __future__ import annotations

import threading
import time

import torch

FAMILY = "lattice.family"  # the span whose calls number the families
PREFIXES = ("lattice.", "goal.", "ops.")  # the layers' span names

_on = False
_records: list = []
_families = 0
_open = threading.local()  # .stack: this thread's open spans' records
_counts: dict = {}


class _Off:
    """What ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_chunk", "_label", "_record", "_range")

    def __init__(self, name: str, chunk, label):
        self._name, self._chunk, self._label = name, chunk, label

    def __enter__(self):
        global _families
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        if self._name == FAMILY:
            family = _families
            _families += 1
        else:
            family = parent["family"] if parent is not None else None
        chunk = self._chunk
        if chunk is None and parent is not None:
            chunk = parent["chunk"]
        record = dict(name=self._name, start_ns=0, end_ns=None,
                      parent=parent["index"] if parent is not None else -1,
                      family=family, chunk=chunk, label=self._label,
                      index=len(_records))
        _records.append(record)
        stack.append(record)
        self._record = record
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        record["start_ns"] = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self._record["end_ns"] = time.monotonic_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        return False


def span(name: str, chunk=None, label=None):
    """A context manager around one step of work (module docstring)."""
    if not _on:
        return _OFF
    return _Span(name, chunk, label)


def enable(flag: bool = True) -> None:
    """Turn tracing on or off; records already kept stay."""
    global _on
    _on = bool(flag)


def enabled() -> bool:
    return _on


def records() -> list:
    """The spans recorded since the last ``reset()``, in the order they
    opened, as dicts: ``name``, ``start_ns``, ``end_ns`` (None while open),
    ``parent``, ``family``, ``chunk``, ``label``."""
    keys = ("name", "start_ns", "end_ns", "parent", "family", "chunk",
            "label")
    return [{k: r[k] for k in keys} for r in _records]


def reset() -> None:
    """Clear the records and restart the family count (no span open)."""
    global _records, _families
    _records = []
    _families = 0


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter: {name: total since the process began}."""
    return dict(_counts)


def since(before: dict, prefix: str = "") -> dict:
    """{name: amount} of the counters under ``prefix`` that moved after the
    snapshot ``before``."""
    return {k: v - before.get(k, 0) for k, v in sorted(_counts.items())
            if k.startswith(prefix) and v != before.get(k, 0)}


def self_times(recs: list) -> dict:
    """{name: [calls, seconds, self seconds]} over closed records: a span's
    self time is its duration less its children's."""
    out, child = {}, [0] * len(recs)
    for r in recs:
        if r["end_ns"] is not None and r["parent"] >= 0:
            child[r["parent"]] += r["end_ns"] - r["start_ns"]
    for i, r in enumerate(recs):
        if r["end_ns"] is None:
            continue
        d = r["end_ns"] - r["start_ns"]
        row = out.setdefault(r["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += d * 1e-9
        row[2] += (d - child[i]) * 1e-9
    return out
