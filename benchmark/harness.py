"""The benchmark's general part: it finds a cell by name and everything that
belongs to it by the names ``BENCHMARK.json`` gives, drives it, reads its
metrics and prints the result line.

- ``BENCHMARK.json`` (at the checkout's root): the cells, configurations
  and metrics.
- ``configs/<config>.json``: a configuration's sizes and the files it loads.
- ``traffic/<traffic>.json``: a traffic mix; its ``driver`` names the
  module of ``drivers/`` that runs it, and the rest are its parameters.
- ``cells/<cell>.json``: the limits of the numbers that decide ``correct``.
- ``metrics/<metric>.py``: one per-layer metric; ``read(layer)`` returns a
  number from what the driver recorded, or None when there is nothing to
  read there.
- ``held/<cell>.json``: the manifest entries of a cell that is built and
  checked but held out of ``BENCHMARK.json``, because its runs spread too
  widely for a bound (``PERF.md``). The command never runs it; the tests and
  ``calibrate.py`` do, and a later change to the benchmark adds the entries
  to ``BENCHMARK.json`` as they stand.

A driver's ``run(cell)`` returns a ``Outcome``. Adding a cell, a traffic
mix, a configuration or a per-layer metric is adding its entry and its
files: no code here names one.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import signal
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
HELD = HERE / "held"
# top-level modules no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "irbfn_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0  # time.time() at the process's start
    end_to_end: tuple = ()  # the cell's end-to-end metric names
    # also judge the control (the reference in the next precision down, in
    # the program's place): the calibration's runs, never the command's
    control: bool = False


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # name -> value
    layer: dict  # what the per-layer readers read
    checks: dict  # name -> value (limits come from the cell's file)
    memory_peak_bytes: int
    trace: dict | None = None  # trace.summarize(), averaged over chips
    device_kind: str = ""
    device_count: int = 1


def load_manifest(path: Path = MANIFEST, held: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held``, also every held cell's entries."""
    if not path.exists():
        raise BenchError(f"{path.name} is missing")
    manifest = json.loads(path.read_text())
    if held:
        for f in sorted(HELD.glob("*.json")):
            for key, entries in json.loads(f.read_text()).items():
                manifest[key] = manifest[key] + entries
    return manifest


def _read_json(path: Path, what: str) -> dict:
    if not path.exists():
        raise BenchError(f"{what}: {path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def resolve(manifest: dict, workload: str, seed: int, seconds: float,
            trace: bool, overrides: dict | None = None,
            device: str = "cuda") -> Cell:
    """The cell ``workload`` with its configuration, traffic and limits;
    ``overrides`` replaces traffic parameters (the tests' small sizes)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"no cell {workload!r} in {MANIFEST.name}; "
                         f"cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(ROOT / configs[w["config"]]["file"], "configuration")
    traffic = _read_json(HERE / "traffic" / f"{w['traffic']}.json",
                         "traffic")
    traffic.update(overrides or {})
    limits = _read_json(HERE / "cells" / f"{workload}.json",
                        "cell")["limits"]
    e2e = tuple(m["name"] for m in manifest["end_to_end"]
                if workload in m.get("workloads", [workload]))
    return Cell(workload, config, traffic, limits, int(w["chips"]),
                int(seed), float(seconds), bool(trace), device,
                end_to_end=e2e)


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def layer_metrics(manifest: dict, cell: Cell, layer: dict) -> dict:
    """Every per-layer metric that applies to the cell and whose reader
    finds something: {name: value}."""
    out = {}
    for m in manifest["per_layer"]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        if m["moves"] not in cell.end_to_end:
            continue
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{len(out)}", path)
        if spec is None or not path.exists():
            raise BenchError(f"metric {m['name']}: {path.name} is missing")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(layer)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def forbidden_modules() -> list:
    """The forbidden top-level modules this process holds, compared by
    whole top-level name (``irbfn_tpu_torch`` is not ``irbfn_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def adopt_orphans() -> None:
    """Make this process the reaper of whatever its children leave behind
    (Linux's child subreaper), so that ``stop_children`` finds it too."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def children() -> list:
    """The pids of this process's children, from ``/proc``."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me:
            out.append(int(d))
    return out


def _reap(pid: int) -> bool:
    """Collect ``pid`` if it has ended; True once it is gone."""
    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        return True


def _wait(pids: list, seconds: float) -> list:
    """Reap ``pids`` as they end, for at most ``seconds``; the ones left."""
    deadline = time.monotonic() + seconds
    left = [pid for pid in pids if not _reap(pid)]
    while left and time.monotonic() < deadline:
        time.sleep(0.02)
        left = [pid for pid in left if not _reap(pid)]
    return left


def _signal(pids: list, sig) -> None:
    for pid in pids:
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass


def stop_children(grace: float = 5.0) -> list:
    """Stop every process this one started and wait until each has ended:
    multiprocessing's resource tracker (the ranks' ``spawn`` starts it, and
    some Pythons leave it to end after this process), told to end by
    closing its pipe, then any other child or adopted orphan. A process
    still there after ``grace`` seconds gets SIGTERM, and SIGKILL after
    ``grace`` more. Returns the pids that had to be signalled."""
    gc.collect()
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None:
            os.close(tracker._fd)  # the tracker ends when its pipe closes
            tracker._fd = tracker._pid = None
    left = _wait(children(), grace)
    _signal(left, signal.SIGTERM)
    _signal(_wait(left, grace), signal.SIGKILL)
    _wait(left, grace)
    return left


def checks_table(checks: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number compared; a number
    without a limit is an error of the cell's file."""
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise BenchError(f"no limit for {missing}")
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in checks.items()}


def is_correct(table: dict, outcome: Outcome) -> bool:
    return (outcome.attempted > 0 and outcome.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in table.values()))


def units_of(manifest: dict) -> dict:
    return {m["name"]: m["unit"]
            for m in manifest["end_to_end"] + manifest["per_layer"]}


def result_line(manifest: dict, cell: Cell, outcome: Outcome) -> dict:
    """The result line's object, in the contract's keys, with the numbers
    compared last."""
    units = units_of(manifest)
    table = checks_table(outcome.checks, cell.limits)
    if cell.trace:
        values = layer_metrics(manifest, cell, outcome.layer)
    else:
        values = {k: outcome.end_to_end[k] for k in cell.end_to_end}
    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": outcome.device_kind, "count": outcome.device_count,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": is_correct(table, outcome),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": {k: {"value": float(v), "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if cell.trace and outcome.trace is not None:
        device["busy_s"] = float(outcome.trace["busy_s"])
        device["window_s"] = float(outcome.trace["window_s"])
        line["breakdown"] = {"device_ops": outcome.trace["top_ops"][:10],
                             "idle_gaps": outcome.trace["idle_gaps"][:10]}
    line["checks"] = table
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             overrides: dict | None = None, device: str = "cuda",
             control: bool = False):
    """Drive one cell, held cells too, in this process and return (result
    line, Outcome): the command's run without its look for cards (the tests
    run it on the CPU at small sizes)."""
    import time

    manifest = load_manifest(held=True)
    cell = resolve(manifest, workload, seed, seconds, trace, overrides,
                   device)
    cell.t_start = time.time()
    cell.control = control
    outcome = driver(cell).run(cell)
    return result_line(manifest, cell, outcome), outcome
