"""On the card: a goal family's operand build as one CUDA graph
(``solvers/goal_mpc.py:_family_matrices``). A replay gives the eager
build's bits at batch (1,) (the lattice's and ``solve_goal_family``'s
shape), at a number (batch ()) and at the planner's, the eval's and the
Oschersleben loop's batches; what a call returned stays as it was when the
graph replays again; the counters read one capture a key and one replay a
later call, and a lattice call one replay a family.

Imports no JAX, so that it runs where the card is:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_operand_graph_card.py`` (``tests/conftest.py`` sets JAX up
for the CPU tests). Without a card the tests skip."""

import numpy as np
import pytest
import torch

from irbfn_tpu_torch.solvers import goal_mpc as P
from irbfn_tpu_torch.utils import spans

CFG = P.GoalMPCConfig()
F32 = torch.float32


@pytest.fixture
def cuda(monkeypatch):
    """The card with an empty graph cache, or a skip: decided when a test
    runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(P, "_OPERAND_GRAPHS", P._GraphCache(8))
    return torch.device("cuda", torch.cuda.current_device())


def _parts(out) -> list:
    fam, rho, kinv = out
    return [*fam, rho, kinv]


def _assert_bits(got, want, msg=""):
    """The same shapes, dtypes and bits, field by field."""
    for i, (a, b) in enumerate(zip(_parts(got), _parts(want))):
        assert a.shape == b.shape and a.dtype == b.dtype, (msg, i)
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32)), (msg, i)


def _moved(before) -> tuple:
    now = spans.counters()
    return tuple(now.get(k, 0) - before.get(k, 0)
                 for k in ("goal.operand_graph_captures",
                           "goal.operand_graph_replays",
                           "goal.operand_builds"))


def test_a_replay_is_the_eager_build_at_one_family(cuda):
    before = spans.counters()
    P._family_matrices(torch.tensor([2.0], device=cuda), CFG, 1e-6, F32,
                       cuda)
    P._family_matrices(2.0, CFG, 1e-6, F32, cuda)
    assert _moved(before) == (2, 0, 2)
    for v in (-1.0, 0.0, 3.5, 8.0):
        t = torch.tensor([v], device=cuda)
        _assert_bits(P._family_matrices(t, CFG, 1e-6, F32, cuda),
                     P._build_matrices(t, CFG, 1e-6, F32, cuda), v)
        _assert_bits(P._family_matrices(v, CFG, 1e-6, F32, cuda),
                     P._build_matrices(v, CFG, 1e-6, F32, cuda), v)
    assert _moved(before) == (2, 8, 10)


@pytest.mark.parametrize("n", [1000, 4096, 27])
def test_a_replay_is_the_eager_build_at_a_batch(cuda, n):
    """The goal planner's 1000 lanes, the eval's 4,096-row truth and the
    Oschersleben loop's F = 27: seeded speeds over the lattice's range."""
    rng = np.random.default_rng(n)
    first = torch.from_numpy(rng.uniform(-1.0, 8.0, n).astype(np.float32))
    P._family_matrices(first.to(cuda), CFG, 1e-6, F32, cuda)
    for _ in range(2):
        v = torch.from_numpy(rng.uniform(-1.0, 8.0, n).astype(np.float32))
        v = v.to(cuda)
        _assert_bits(P._family_matrices(v, CFG, 1e-6, F32, cuda),
                     P._build_matrices(v, CFG, 1e-6, F32, cuda), n)
    # a strided column, as solve_goal_mpc passes its inputs' first one
    rows = torch.from_numpy(rng.uniform(-1.0, 8.0, (n, 5))
                            .astype(np.float32)).to(cuda)
    _assert_bits(P._family_matrices(rows[:, 0], CFG, 1e-6, F32, cuda),
                 P._build_matrices(rows[:, 0], CFG, 1e-6, F32, cuda), n)


def test_a_later_replay_leaves_what_a_call_returned(cuda):
    v = torch.tensor([1.0], device=cuda)
    P._family_matrices(v, CFG, 1e-6, F32, cuda)  # the capture
    first = P._family_matrices(v, CFG, 1e-6, F32, cuda)
    kept = [t.clone() for t in _parts(first)]
    second = P._family_matrices(torch.tensor([5.0], device=cuda), CFG, 1e-6,
                                F32, cuda)
    for a, b in zip(_parts(first), kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[1], second[1])  # rho 1.0, then 2.5
    assert not torch.equal(first[2], second[2])


def test_a_replay_waits_for_nothing(cuda):
    """Writing v and replaying call nothing that synchronises the host."""
    t = torch.tensor([3.0], device=cuda)
    P._family_matrices(t, CFG, 1e-6, F32, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        P._family_matrices(t, CFG, 1e-6, F32, cuda)
        P._family_matrices(4.0, CFG, 1e-6, F32, cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_counters_read_one_capture_a_key_and_one_replay_a_later_call(cuda):
    before = spans.counters()
    for n in (1, 1, 1, 1, 3, 3, 1):
        P._family_matrices(torch.full((n,), 2.0, device=cuda), CFG, 1e-6,
                           F32, cuda)
    P._family_matrices(torch.full((1,), 2.0, device=cuda), CFG, 1e-5, F32,
                       cuda)
    assert _moved(before) == (3, 5, 8)


def test_a_lattice_call_replays_once_a_family(cuda):
    """Three lattice families of three chunks: one capture at the first,
    one replay at each later family's first chunk."""
    goals = np.random.default_rng(19).uniform(
        [-1.0, 0.0, -1.0, -3.0], [4.0, 4.0, 8.0, 3.0],
        (10, 4)).astype(np.float32)
    before = spans.counters()
    for v in (0.5, 2.0, 4.0):
        P.solve_goal_lattice(v, goals, CFG, iters=20, batch_per_device=4,
                             device=cuda)
    assert _moved(before) == (1, 2, 3)
