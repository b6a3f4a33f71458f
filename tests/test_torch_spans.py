"""The port's spans and counters (``irbfn_tpu_torch/utils/spans.py``): a
no-op while tracing is off, nested records while it is on, the lattice
pipeline's spans and counters on the CPU (one process, and two gloo ranks),
and the counters that replaced the ops' ``.launches`` attributes and the
NMPC solver's ``LAST_SOLVE_STATS``."""

import contextlib
import time

import numpy as np
import pytest
import torch

from irbfn_tpu_torch.ops import admm
from irbfn_tpu_torch.parallel import datagen, launch
from irbfn_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, Mesh
from irbfn_tpu_torch.solvers import goal_mpc, nmpc
from irbfn_tpu_torch.solvers.goal_mpc import (GoalMPCConfig,
                                              solve_goal_family,
                                              solve_goal_lattice)
from irbfn_tpu_torch.utils import spans


@pytest.fixture
def tracing():
    """Tracing on with no records; off again, and cleared, afterwards."""
    was = spans.enabled()
    spans.enable(True)
    spans.reset()
    yield
    spans.enable(was)
    spans.reset()


def _delta(before: dict, name: str) -> int:
    return spans.counters().get(name, 0) - before.get(name, 0)


def _assert_same(a, b):
    """Equal arrays, or dicts of them, dtypes included."""
    if not isinstance(a, dict):
        a, b = {"": a}, {"": b}
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_off_reads_no_clock_and_opens_no_range(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(time, "monotonic_ns", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    spans.enable(False)
    spans.reset()
    first = spans.span("lattice.stage", 0, label="chunk")
    with first, spans.span(spans.FAMILY):
        pass
    assert first is spans.span("goal.operands")  # one shared object
    assert spans.records() == []


def test_records_nest_with_parent_family_and_chunk(tracing, monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    with spans.span("ops.library", label="admm_solve"):
        pass
    for _ in range(2):
        with spans.span(spans.FAMILY):
            with spans.span("lattice.solve", 1, label="seven"):
                with spans.span("goal.operands"):
                    pass
            with spans.span("lattice.assemble"):
                with spans.span("lattice.drain", 4):
                    pass
    recs = spans.records()
    assert opened == [r["name"] for r in recs]
    assert [(r["name"], r["parent"], r["family"], r["chunk"])
            for r in recs] == [
        ("ops.library", -1, None, None),
        ("lattice.family", -1, 0, None),
        ("lattice.solve", 1, 0, 1),
        ("goal.operands", 2, 0, 1),
        ("lattice.assemble", 1, 0, None),
        ("lattice.drain", 4, 0, 4),
        ("lattice.family", -1, 1, None),
        ("lattice.solve", 6, 1, 1),
        ("goal.operands", 7, 1, 1),
        ("lattice.assemble", 6, 1, None),
        ("lattice.drain", 9, 1, 4),
    ]
    assert recs[0]["label"] == "admm_solve"
    assert recs[2]["label"] == "seven" and recs[3]["label"] is None
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] >= 0:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p[
                "end_ns"]
    own = spans.self_times(recs)
    assert own["lattice.family"][0] == 2
    assert own["lattice.solve"][2] <= own["lattice.solve"][1]
    spans.reset()
    assert spans.records() == []
    with spans.span(spans.FAMILY):
        pass
    assert spans.records()[0]["family"] == 0  # the count restarts


def test_counters_add_and_snapshot():
    before = spans.counters()
    spans.count("test.counter")
    spans.count("test.counter", 4)
    snap = spans.counters()
    assert _delta(before, "test.counter") == 5
    spans.count("test.counter")
    assert snap["test.counter"] == before.get("test.counter", 0) + 5
    spans.count("test.other", 2)
    assert spans.since(snap, "test.") == {"test.counter": 1,
                                          "test.other": 2}
    assert spans.since(spans.counters(), "test.") == {}


def test_the_table_generator_prints_what_the_pipeline_moved(capsys):
    """``gen_goal_mpc_table`` ends with the ``lattice.`` counters that moved
    on this rank: families, rows and chunks of a tiny CPU grid (3 families
    of 36 goals in chunks of 8: 5 chunks a family), then the ``goal.``
    counters: one operand build a family, no graph on the CPU."""
    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen

    args = gen.parse_args(
        ["--device", "cpu", "--iters", "5", "--chunk", "8",
         "--v_car_min", "0.0", "--v_car_max", "1.0", "--d_v_car", "0.5",
         "--x_goal_min", "0.0", "--x_goal_max", "0.2",
         "--y_goal_min", "0.0", "--y_goal_max", "0.1",
         "--t_goal_min", "0.0", "--t_goal_max", "0.1",
         "--v_goal_min", "0.0", "--v_goal_max", "1.0"])
    res = gen.solve_table(args)
    G = res["goals_raw"].shape[0]
    assert G == 3 * 2 * 2 * 3
    assert res["pipeline"] == {"lattice.chunks": 3 * 5,
                               "lattice.families": 3,
                               "lattice.rows": 3 * G}
    lines = capsys.readouterr().out.strip().splitlines()[-2:]
    assert lines == ["pipeline on this rank: chunks 15, families 3, rows 108",
                     "operands on this rank: operand_builds 3"]


def test_solve_lattice_records_every_chunk(tracing):
    """3.5 chunks: four chunks' stage, solve, put and drain spans, the
    drains the pipeline holds back inside ``lattice.assemble``, and
    ``lattice.rows`` equal to the lattice's rows."""
    rows = np.arange(28, dtype=np.float32).reshape(14, 2)
    before = spans.counters()
    out = datagen.solve_lattice(lambda r: {"s": r.sum(-1)}, rows,
                                batch_per_device=4, device="cpu")
    np.testing.assert_array_equal(out["s"], rows.sum(-1))
    recs = spans.records()
    names = [r["name"] for r in recs]
    assert names[0] == "lattice.family" and names.count(
        "lattice.family") == 1
    for name in ("lattice.stage", "lattice.solve", "lattice.put",
                 "lattice.drain"):
        assert sorted(r["chunk"] for r in recs if r["name"] == name) == [
            0, 1, 2, 3], name
    assemble = names.index("lattice.assemble")
    held = [r for r in recs if r["name"] == "lattice.drain"
            and r["parent"] == assemble]
    assert len(held) == datagen.PIPELINE_DEPTH
    assert all(r["family"] == 0 for r in recs)
    assert _delta(before, "lattice.rows") == 14
    assert _delta(before, "lattice.chunks") == 4
    assert _delta(before, "lattice.families") == 1
    # the card's copies only: none on the CPU
    assert _delta(before, "lattice.h2d_bytes") == 0


def _goal_block(n=10):
    return np.random.default_rng(0).uniform(
        [-1.0, 0.0, -1.0, -3.0], [4.0, 4.0, 8.0, 3.0],
        (n, 4)).astype(np.float32)


def test_goal_lattice_operands_inside_the_chunks_solve(tracing):
    """The family's operands are built once a family call, at its first
    chunk, inside that chunk's ``lattice.solve``: two families of three
    chunks open two ``goal.operands`` spans."""
    goals = _goal_block()
    for v in (2.0, 3.0):
        solve_goal_lattice(v, goals, GoalMPCConfig(), iters=5,
                           batch_per_device=4, device="cpu")
    recs = spans.records()
    ops = [r for r in recs if r["name"] == "goal.operands"]
    assert [(r["family"], r["chunk"]) for r in ops] == [(0, 0), (1, 0)]
    assert all(recs[r["parent"]]["name"] == "lattice.solve" for r in ops)
    assert len([r for r in recs if r["name"] == "lattice.solve"]) == 6


def test_goal_operand_builds_count_one_per_family():
    """Three families of three chunks (the last one ragged): three builds
    of the family's operands, nine chunks, and every family's columns bit
    for bit ``solve_goal_family`` chunk by chunk, concatenated."""
    goals = _goal_block()
    cfg = GoalMPCConfig()
    before = spans.counters()
    outs = {v: solve_goal_lattice(v, goals, cfg, iters=20,
                                  batch_per_device=4, device="cpu")
            for v in (0.5, 2.0, 4.0)}
    assert _delta(before, "goal.operand_builds") == 3
    assert _delta(before, "lattice.chunks") == 9
    for v, out in outs.items():
        parts = [solve_goal_family(v, torch.from_numpy(goals[s:s + 4]), cfg,
                                   iters=20) for s in range(0, 10, 4)]
        _assert_same(out, {k: np.concatenate([getattr(p, k).numpy()
                                              for p in parts])
                           for k in ("speed", "steer", "converged")})


@pytest.mark.parametrize("v", [2.5, torch.tensor([-1.0, 0.0, 3.5, 8.0])])
def test_operand_build_on_the_cpu_is_eager(v):
    """Off the card ``_family_matrices`` runs the eager build: one build a
    call, no graph captured, kept or replayed, and its outputs are
    ``condensed_family``'s, rho and the KKT inverse, as before the graph."""
    cfg = GoalMPCConfig()
    before = spans.counters()
    kept = len(goal_mpc._OPERAND_GRAPHS)
    fam, rho, kinv = goal_mpc._family_matrices(v, cfg, 1e-6, torch.float64,
                                               torch.device("cpu"))
    assert _delta(before, "goal.operand_builds") == 1
    assert _delta(before, "goal.operand_graph_captures") == 0
    assert _delta(before, "goal.operand_graph_replays") == 0
    assert len(goal_mpc._OPERAND_GRAPHS) == kept
    ref = goal_mpc.condensed_family(v, cfg, torch.float64, "cpu")
    for a, b in zip(fam, ref):
        assert torch.equal(a, b)
    speed = torch.as_tensor(v, dtype=torch.float64)
    assert torch.equal(rho, torch.clamp(speed.abs() * 0.5, min=1.0))
    eye = torch.eye(16, dtype=torch.float64)
    kkt = ref.P + 1e-6 * eye + rho[..., None, None] * (
        ref.A_con.transpose(-1, -2) @ ref.A_con)
    torch.testing.assert_close(kinv @ kkt, eye.expand(kkt.shape),
                               rtol=0, atol=1e-9)


class _StubGraph:
    """Stands in for ``_OperandGraph`` off the card: records its key and
    answers with the eager build."""

    def __init__(self, *key):
        self.key = key
        self.made.append(key)

    def __call__(self, v_car):
        return goal_mpc._build_matrices(v_car, *self.key[:4])


def test_operand_graph_cache_keys_and_bound(monkeypatch):
    """One graph a (cfg, sigma, dtype, device, batch shape): a key's first
    call captures and builds eagerly, a later call replays; the cache keeps
    the 8 keys used last, so an evicted key captures again."""
    monkeypatch.setattr(goal_mpc, "_OperandGraph", _StubGraph)
    monkeypatch.setattr(goal_mpc, "_graphed", lambda device: True)
    monkeypatch.setattr(goal_mpc, "_OPERAND_GRAPHS", goal_mpc._GraphCache(8))
    monkeypatch.setattr(_StubGraph, "made", [], raising=False)
    cfg, cpu, f32 = GoalMPCConfig(), torch.device("cpu"), torch.float32
    before = spans.counters()

    def build(v, sigma=1e-6, dtype=f32, c=cfg):
        out = goal_mpc._family_matrices(v, c, sigma, dtype, cpu)
        ref = goal_mpc._build_matrices(v, c, sigma, dtype, cpu)
        for a, b in zip((*out[0], *out[1:]), (*ref[0], *ref[1:])):
            assert torch.equal(a, b)

    def moved():
        return (_delta(before, "goal.operand_graph_captures"),
                _delta(before, "goal.operand_graph_replays"))

    build(torch.tensor([2.0]))
    assert moved() == (1, 0)
    assert _StubGraph.made == [(cfg, 1e-6, f32, cpu, (1,))]
    build(torch.tensor([3.0]))
    assert moved() == (1, 1)
    build(torch.tensor([1.0, 2.0, 3.0]))  # another shape
    build(torch.tensor([2.0]), dtype=torch.float64)  # another dtype
    build(torch.tensor([2.0]), sigma=1e-5)  # another sigma
    build(2.0)  # a number: batch ()
    build(torch.tensor([2.0]), c=cfg._replace(r_steer=4.0))  # another cfg
    build(torch.zeros(2))
    assert moved() == (7, 1)
    assert len(goal_mpc._OPERAND_GRAPHS) == 7
    build(torch.zeros(4))
    assert len(goal_mpc._OPERAND_GRAPHS) == 8
    build(torch.tensor([5.0]))  # the first key, used again
    assert moved() == (8, 2)
    build(torch.zeros(6))  # a ninth key evicts the least recently used
    assert len(goal_mpc._OPERAND_GRAPHS) == 8
    build(torch.tensor([1.0, 2.0, 3.0]))  # the (3,) key: captured again
    build(torch.tensor([-1.0]))  # still kept
    assert moved() == (10, 3)
    assert [k[4] for k in _StubGraph.made].count((3,)) == 2
    assert _delta(before, "goal.operand_builds") == 13


def _sharded_rank(rows, bpd):
    spans.enable(True)
    spans.reset()
    before = spans.counters()
    out = datagen.solve_lattice_sharded(
        lambda r: {"s": r.sum(-1), "b": r[:, 0] > 10}, rows,
        batch_per_device=bpd, device="cpu")
    return (out, {k: _delta(before, k) for k in
                  ("lattice.pad_rows", "lattice.rows", "lattice.gather_bytes",
                   "lattice.chunks", "lattice.split_rounds")},
            [(r["name"], r["chunk"]) for r in spans.records()])


def test_sharded_lattice_counts_the_split(tmp_path):
    """Two gloo ranks, 13 rows in blocks of 4: a whole chunk of (4, 4) rows,
    then a short one of a block and a 1-row tail, split evenly as (2, 3):
    the block in shares of 2, the tail a second solve on rank 1. So rank 0
    pads 1 row and rank 1 none; every rank counts its own rows and solve
    calls, gathers both blocks of both columns and counts one split."""
    rows = np.arange(26, dtype=np.float32).reshape(13, 2)
    per_rank = launch.spawn(_sharded_rank, 2, "cpu", rows, 4,
                            store_dir=tmp_path)
    sizes = [[4, 4], [2, 3]]
    for rank, (out, counts, recs) in enumerate(per_rank):
        np.testing.assert_array_equal(out["s"], rows.sum(-1))
        assert counts["lattice.pad_rows"] == sum(max(s) - s[rank]
                                                 for s in sizes)
        assert counts["lattice.rows"] == sum(s[rank] for s in sizes)
        assert counts["lattice.chunks"] == 2 + rank
        assert counts["lattice.split_rounds"] == 1
        # 2 ranks' blocks padded to 4, then 3 rows: a float32 and a uint8
        # column
        assert counts["lattice.gather_bytes"] == 2 * (4 + 1) * (4 + 3)
        assert [c for n, c in recs if n == "lattice.gather"] == [0, 1]
        assert [c for n, c in recs if n == "lattice.solve"] == (
            [0, 1] + [1] * rank)
    assert per_rank[0][1]["lattice.pad_rows"] == 1
    assert per_rank[1][1]["lattice.pad_rows"] == 0


class _DataAxis:
    """A device mesh whose data axis is a group no collective runs on."""

    @staticmethod
    def get_group(axis):
        return axis


# (rows, rows a block, ranks) -> each chunk's blocks, the last chunk's tail
# and the even splits counted: a world of one; a last chunk under a block
# (k = 0); one of a block and 2 rows on four ranks (k < D/2), dealt a block
# a rank; k >= D/2 with a tail and without, split evenly; and the default
# goal family in chunks of 262,144 on four cards
DEALS = [
    ((10, 4, 1), [[4], [4], [2]], 0, 0),
    ((10, 4, 2), [[4, 4], [2, 0]], 0, 0),
    ((22, 4, 4), [[4, 4, 4, 4], [4, 2, 0, 0]], 0, 0),
    ((23, 4, 3), [[4, 4, 4], [3, 3, 5]], 3, 1),
    ((20, 4, 3), [[4, 4, 4], [3, 3, 2]], 0, 1),
    ((2642368, 262144, 4), [[262144] * 4, [262144] * 4,
                            [131072, 131072, 131072, 152000]], 20928, 1),
]


@pytest.mark.parametrize("shape, sizes, tail, splits", DEALS)
def test_each_rank_solves_its_share_of_each_chunk(monkeypatch, shape, sizes,
                                                  tail, splits):
    """Each data rank's solve calls and each chunk's blocks, the ranks run
    in turn in one process with the gather stood in for: a short last
    chunk of k >= D/2 blocks goes in even shares, the earlier ranks taking
    the extra rows, and its tail as a second call on the last rank; every
    other chunk a block a rank, an empty block solving the last row as a
    stand-in. ``lattice.split_rounds`` counts the even splits."""
    n, bpd, D = shape
    rows = np.arange(n, dtype=np.float32)[:, None]
    dealt = []

    def gather(t, blocks, group):
        dealt.append(list(blocks))
        return [t.new_zeros((m,) + t.shape[1:]) for m in blocks]

    monkeypatch.setattr(datagen, "_gather_rows", gather)
    for i in range(D):
        calls = []

        def solve(r):
            calls.append((int(r[0, 0]), r.shape[0]))
            return r[:, 0]

        dealt.clear()
        before = spans.counters()
        mesh = Mesh(torch.device("cpu"), {DATA_AXIS: D, EXPERT_AXIS: 1}, i,
                    _DataAxis())
        datagen.solve_lattice_sharded(solve, rows, mesh, bpd)
        assert dealt == sizes
        # (first row, rows) of each call: the blocks lie end to end
        want, start = [], 0
        for s in sizes:
            lo = start + sum(s[:i])
            want.append((lo, s[i]) if s[i] else (n - 1, 1))
            start += sum(s)
        if tail and i == D - 1:
            lo, m = want.pop()
            want += [(lo, m - tail), (lo + m - tail, tail)]
        assert calls == want
        assert _delta(before, "lattice.rows") == sum(s[i] for s in sizes)
        assert _delta(before, "lattice.pad_rows") == sum(
            max(s) - s[i] for s in sizes)
        assert _delta(before, "lattice.split_rounds") == splits


def _rows(n: int) -> np.ndarray:
    return (10 * np.random.default_rng(n).normal(size=(n, 2))).astype(
        np.float32)


def _columns_fn(r):
    """A solver with a float, a bool and a 2-D column."""
    return {"s": r.sum(-1), "b": r[:, 0] > 0,
            "w": torch.stack([r[:, 1], r[:, 0] * 2, r.sum(-1)], -1)}


def _bare_fn(r):
    return r[:, 0] - r[:, 1]


def _chunked(fn, rows, bpd):
    """The plain composition: ``fn`` on each chunk of ``bpd`` rows, the
    chunks' results concatenated."""
    outs = [fn(torch.from_numpy(rows[s:s + bpd]))
            for s in range(0, rows.shape[0], bpd)]
    if torch.is_tensor(outs[0]):
        return np.concatenate([o.numpy() for o in outs])
    return {k: np.concatenate([o[k].numpy() for o in outs]) for k in outs[0]}


SOLVES = {"solve_lattice": datagen.solve_lattice,
          "sharded": datagen.solve_lattice_sharded}


@pytest.mark.parametrize("n, bpd", [(14, 4), (12, 4), (3, 8)])
@pytest.mark.parametrize("path, fn", [("solve_lattice", _columns_fn),
                                      ("sharded", _columns_fn),
                                      ("sharded", _bare_fn)])
def test_columns_are_the_chunks_concatenated(path, fn, n, bpd):
    """The columns each chunk's results were copied into are, bit for bit,
    the chunks' results concatenated: a ragged last chunk, whole chunks
    and one short chunk; a dict of float, bool and 2-D columns, and on
    the sharded path (a world of one) a bare tensor."""
    rows = _rows(n)
    out = SOLVES[path](fn, rows, batch_per_device=bpd, device="cpu")
    _assert_same(out, _chunked(fn, rows, bpd))


@pytest.mark.parametrize("path", list(SOLVES))
def test_a_second_call_leaves_the_first_calls_columns(path):
    """The columns are new on every call: the arrays a call returned keep
    their values through the next call."""
    rows = _rows(14)
    first = SOLVES[path](_columns_fn, rows, batch_per_device=4, device="cpu")
    kept = {k: v.copy() for k, v in first.items()}
    second = SOLVES[path](_columns_fn, 3 * rows[::-1] + 1,
                          batch_per_device=4, device="cpu")
    _assert_same(first, kept)
    assert not np.array_equal(first["s"], second["s"])


# (rows, rows a block) on four ranks: a chunk of 2 blocks and 2 rows, split
# evenly as (2, 2, 2, 4); (16 rows; 3, 3, 3, 4), the last chunk's 3 blocks
# in shares of 3 and its 1-row tail; and a chunk of a block and 2 rows,
# dealt as (4, 2, 0, 0), the last two ranks' blocks empty
FOUR_RANK_CASES = [(10, 4), (29, 4), (6, 4)]


def _four_rank_columns():
    return [(datagen.solve_lattice_sharded(_columns_fn, _rows(n),
                                           batch_per_device=bpd,
                                           device="cpu"),
             datagen.solve_lattice_sharded(_bare_fn, _rows(n),
                                           batch_per_device=bpd,
                                           device="cpu"))
            for n, bpd in FOUR_RANK_CASES]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return launch.spawn(_four_rank_columns, 4, "cpu",
                        store_dir=tmp_path_factory.mktemp("four"))


@pytest.mark.parametrize("case", range(len(FOUR_RANK_CASES)))
def test_four_ranks_fill_the_columns_with_every_block(four_ranks, case):
    """Four gloo ranks: every rank's columns are every rank's blocks,
    each written into its rows, bit for bit the chunks concatenated, for a
    dict of float, bool and 2-D columns and for a bare tensor."""
    n, bpd = FOUR_RANK_CASES[case]
    rows = _rows(n)
    for per_rank in four_ranks:
        cols, bare = per_rank[case]
        _assert_same(cols, _chunked(_columns_fn, rows, bpd))
        _assert_same(bare, _chunked(_bare_fn, rows, bpd))


class _FakeStream:
    cuda_stream = 0


class _FakeADMM:
    """The kernel's library with a launch that does nothing."""

    @staticmethod
    def admm_solve_f32(*args):
        return 0


@pytest.mark.parametrize("F, G, variant", [(1, 40960, "family"),
                                           (5, 1, "lane")])
def test_admm_launches_count_by_variant(monkeypatch, tracing, F, G,
                                        variant):
    """One launch adds one to ``ops.admm.<variant>`` (what
    ``admm_solve.launches`` counted, now split by variant) inside one
    ``ops.admm`` span; the card's calls are stood in for on the CPU."""
    monkeypatch.setattr(admm, "_library", lambda: _FakeADMM)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: _FakeStream)
    T = 8
    n, m = 2 * T, 4 * T - 1
    q = torch.zeros((F, G, n))
    ops = (torch.zeros((F, m, n)), torch.zeros((F, n, n)),
           torch.zeros((F, m)), torch.zeros((F, m)), torch.ones(F))
    before = spans.counters()
    admm._launch(q, *ops, 600, 1e-6, 1.6)
    assert _delta(before, f"ops.admm.{variant}") == 1
    other = "lane" if variant == "family" else "family"
    assert _delta(before, f"ops.admm.{other}") == 0
    (r,) = spans.records()
    assert r["name"] == "ops.admm" and r["label"] == variant


def test_newton_iterations_count_every_pass(monkeypatch):
    """``nmpc.newton_iterations`` adds one for each Newton pass, as
    ``LAST_SOLVE_STATS["newton_iterations"]`` did within a solve."""
    from irbfn_tpu_torch.dynamics.params import f1tenth_params

    passes = []
    real = nmpc._newton_iteration

    def counted(*args):
        passes.append(1)
        return real(*args)

    monkeypatch.setattr(nmpc, "_newton_iteration", counted)
    rows = torch.tensor([[0.0, 0.0, 5.0, 0.0, 5.0, 0.0, 0.0, 0.0],
                         [1.9, 0.3, 7.0, -1.0, 3.0, 2.6, -1.0, 0.1]],
                        dtype=torch.float64)
    before = spans.counters()
    nmpc.solve_lattice_point(
        rows, f1tenth_params(dtype=torch.float64, device="cpu"),
        nmpc.NMPCConfig(gn_iters=3, al_outer=2), device="cpu")
    assert _delta(before, "nmpc.newton_iterations") == len(passes) > 0
