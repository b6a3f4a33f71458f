"""The readers of the port's spans (``benchmark/program.py``): on synthetic
views, and on two gloo ranks of the sharded lattice with a delay planted
before rank 1's gathers."""

import time

import numpy as np
import pytest

from benchmark import program


def _rec(name, s, e, parent=-1, family=None, chunk=None):
    return dict(name=name, start_ns=s, end_ns=e, parent=parent,
                family=family, chunk=chunk, label=None)


def _view(device, marks, window=(), setup=()):
    return dict(device=[list(d) for d in device],
                marks=[list(m) for m in marks], window=list(window),
                setup=list(setup))


def test_pipeline_idle_is_gaps_inside_the_pipeline_spans():
    # kernels (us): busy 0-10, 20-30, 31-40, 60-70; gaps 10-20, 40-60
    # (30-31 is under the 2 us floor)
    dev = [(0, 10, False), (20, 30, False), (31, 40, False),
           (60, 70, False)]
    # the host: in lattice.stage 5-15, lattice.drain 45-50, goal.operands
    # (not the pipeline's) 50-58
    marks = [("lattice.stage", 5, 15), ("lattice.drain", 45, 50),
             ("goal.operands", 50, 58)]
    view = _view(dev, marks)
    assert program.gaps(dev) == [[10, 20], [40, 60]]
    assert program.pipeline_idle_us(view) == pytest.approx(5 + 5)
    window_s = 100e-6
    layer = {"program": [view], "trace": {"window_s": window_s,
                                          "busy_s": 37e-6}}
    share = program.pipeline_idle_share(layer)
    assert share == pytest.approx(10.0)
    idle = 100 * (1 - layer["trace"]["busy_s"] / window_s)
    assert share <= idle
    split = program.idle_by_span(view)
    assert split == pytest.approx({"lattice.stage": 5e-6,
                                   "lattice.drain": 5e-6,
                                   "goal.operands": 8e-6,
                                   "outside": 12e-6})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_idle_never_exceeds_the_idle_share(seed):
    rng = np.random.default_rng(seed)
    t, dev = 0.0, []
    for _ in range(200):
        t += rng.exponential(5.0)
        d = rng.exponential(20.0)
        dev.append((t, t + d, False))
        t += d
    marks = []
    s = 0.0
    while s < t:
        d = rng.exponential(40.0)
        marks.append(("lattice.solve", s, s + d))
        s += d + rng.exponential(10.0)
    window = t * 1e-6
    busy = sum(e - s for s, e in program._union((a, b) for a, b, _ in dev))
    layer = {"program": [_view(dev, marks)],
             "trace": {"window_s": window, "busy_s": busy * 1e-6}}
    idle = 100 * (1 - busy * 1e-6 / window)
    share = program.pipeline_idle_share(layer)
    assert 0 < share <= idle + 1e-9
    assert sum(program.idle_by_span(layer["program"][0]).values()) \
        == pytest.approx(sum(b - a for a, b in program.gaps(dev)) * 1e-6)


def test_the_clock_offset_comes_from_the_spans_in_both_records():
    # the profiler's clock reads 1.25 s - 3 us of jitter ahead of the
    # port's, its base unknown to the reader
    off_us = 1_250_000.0
    window, marks = [], []
    for k, name in enumerate(["lattice.stage", "lattice.solve",
                              "lattice.stage", "lattice.gather"] * 3):
        s_ns = 7_000_000_000 + 100_000 * k
        window.append(_rec(name, s_ns, s_ns + 50_000))
        jitter = (-3.0, 0.0, 3.0)[k % 3]
        marks.append((name, s_ns / 1e3 + off_us + jitter,
                      (s_ns + 50_000) / 1e3 + off_us))
    view = _view([], marks, window)
    assert program.offset_ns(view) == pytest.approx(off_us * 1e3)
    assert program.offset_ns(_view([], [], window)) is None


@pytest.mark.parametrize("before, after", [(0, 0), (1, 0), (3, 2), (0, 5)])
def test_spans_outside_the_profiled_stretch_shift_no_pair(before, after):
    """The port recorded ``before`` spans ahead of the profiler's start and
    ``after`` behind its stop, in the pipeline's repeating pattern; the
    profiler saw the rest. The offset is still the profiler's lead."""
    off_us = 2_000_000.0
    pattern = ["lattice.stage", "lattice.solve", "goal.operands",
               "ops.admm", "lattice.put"]
    names = pattern * 4
    window, marks = [], []
    for k, name in enumerate(names):
        s_ns = 9_000_000_000 + 100_000 * k
        window.append(_rec(name, s_ns, s_ns + 50_000))
        if before <= k < len(names) - after:
            marks.append((name, s_ns / 1e3 + off_us,
                          (s_ns + 50_000) / 1e3 + off_us))
    view = _view([], marks, window)
    assert program.offset_ns(view) == pytest.approx(off_us * 1e3)


def test_arrival_is_the_later_of_the_host_and_the_device(monkeypatch):
    off = 500_000  # ns: the profiler's clock ahead of the port's
    # rank: gathers of chunks 0 and 1 open at 1,000 and 5,000 us (port);
    # its kernels before the first ring kernel of each end at 3,000 us
    # (device later than the host) and 5,500 us (... later again), two
    # ring kernels a gather
    window = [_rec("lattice.gather", 1_000_000, 1_100_000, family=0,
                   chunk=0),
              _rec("lattice.gather", 5_000_000, 5_100_000, family=0,
                   chunk=1)]
    marks = [("lattice.gather", 1_500.0, 1_600.0),
             ("lattice.gather", 5_500.0, 5_600.0)]
    dev = [(2_000.0, 3_500.0, False), (3_600.0, 3_700.0, True),
           (3_700.0, 3_800.0, True), (4_000.0, 6_000.0, False),
           (6_100.0, 6_200.0, True), (6_200.0, 6_300.0, True)]
    arr = program.arrivals(_view(dev, marks, window))
    assert arr[0, 0] == pytest.approx(3_500_000 - off)
    assert arr[0, 1] == pytest.approx(6_000_000 - off)
    # rank 0 arrives first at chunk 0 by 1 ms and last at chunk 1
    r0 = {(0, 0): 2_000_000.0, (0, 1): 6_000_000.0}
    r1 = {(0, 0): 3_000_000.0, (0, 1): 5_000_000.0}
    monkeypatch.setattr(program, "arrivals", lambda v: v)
    assert program.gather_waits([r0, r1]) == {0: 1_000_000.0}


def test_setup_counts_the_top_level_spans_once():
    recs = [_rec("ops.library", 0, 2_000_000_000),
            _rec(program.PIPELINE + "family", 3_000_000_000, 4_500_000_000),
            _rec("ops.library", 3_100_000_000, 3_400_000_000, parent=1),
            _rec("lattice.stage", 3_500_000_000, None, parent=1)]
    assert program.setup_seconds(recs) == pytest.approx(3.5)
    view = _view([], [], setup=recs)
    assert program.setup_program_s({"program": [view]}) == pytest.approx(
        3.5)
    assert program.setup_program_s({}) is None
    assert program.gather_wait_ms({"program": [view]}) is None
    assert program.pipeline_idle_share({"program": [view]}) is None


def _rank(delay):
    """One gloo rank of the sharded lattice, traced as a ``--trace 1`` run
    traces it; rank 1 first waits ``delay`` s after each chunk's solve,
    before its gather."""
    import torch
    import torch.distributed as dist

    from benchmark.trace import profile
    from irbfn_tpu_torch.parallel import datagen

    if delay and dist.get_rank() == 1:
        solve_chunk = datagen._solve_chunk

        def late(*args):
            out = solve_chunk(*args)
            time.sleep(delay)
            return out

        datagen._solve_chunk = late
    rows = np.arange(26, dtype=np.float32).reshape(13, 2)

    def solve(r):
        return {"s": r.sum(-1), "b": r[:, 0] > 10}

    program.begin()
    datagen.solve_lattice_sharded(solve, rows, batch_per_device=4,
                                  device="cpu")
    setup = program.take()
    with profile(torch.device("cpu")) as p:
        dist.barrier()  # the ranks' profilers start apart
        for _ in range(2):
            datagen.solve_lattice_sharded(solve, rows, batch_per_device=4,
                                          device="cpu")
    return program.rank_view(p, setup, program.take())


@pytest.mark.parametrize("delay", [0.0, 0.1])
def test_a_late_rank_shows_in_rank_0s_gather_wait(delay, tmp_path):
    from irbfn_tpu_torch.parallel.launch import spawn

    views = spawn(_rank, 2, "cpu", delay, store_dir=tmp_path)
    layer = {"program": views}
    wait = program.gather_wait_ms(layer)
    # two chunks a family, rank 1 late by ``delay`` at each
    print(f"gather wait {wait:.3f} ms at a delay of {delay} s")
    if delay:
        assert wait >= 1e3 * delay
    else:
        assert wait < 20.0
    assert sorted(program.gather_waits(views)) == [0, 1]
    for v in views:
        assert program.offset_ns(v) is not None
        assert [r["name"] for r in v["setup"]].count("lattice.family") == 1
    assert program.setup_program_s(layer) > 0
