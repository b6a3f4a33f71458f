"""On the card: the goal lattice's host columns. ``solve_goal_lattice`` at
the generator's 600 sweeps and 262,144-goal chunks, on a family of three
chunks whose last is ragged (the lane variant's 20,928 goals of a default
family's last chunk), against ``solve_goal_family`` chunk by chunk and
``np.concatenate``, bit for bit; and what a second call pins.

Imports no JAX, so that it runs where the card is:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lattice_card.py``
(``tests/conftest.py`` sets JAX up for the CPU tests). Without a card the
tests skip."""

import numpy as np
import pytest
import torch

from irbfn_tpu_torch.solvers.goal_mpc import (GoalMPCConfig,
                                              solve_goal_family,
                                              solve_goal_lattice)
from irbfn_tpu_torch.utils import spans

SWEEPS = 600
CHUNK = 262144
G = 2 * CHUNK + 20928
COLUMNS = ("speed", "steer", "converged")


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _goals() -> np.ndarray:
    """Goals drawn over the default lattice's ranges (x, y, v, t)."""
    return np.random.default_rng(16).uniform(
        [-1.2, 0.0, -1.0, -3.14], [4.0, 4.0, 8.0, 3.14],
        (G, 4)).astype(np.float32)


def test_goal_lattice_columns_are_the_family_solves_concatenated(cuda):
    goals = _goals()
    cfg = GoalMPCConfig()
    for v in (0.5, 6.0):
        out = solve_goal_lattice(v, goals, cfg, iters=SWEEPS,
                                 batch_per_device=CHUNK, device=cuda)
        parts = [solve_goal_family(v, torch.from_numpy(goals[s:s + CHUNK])
                                   .to(cuda), cfg, iters=SWEEPS)
                 for s in range(0, G, CHUNK)]
        for k in COLUMNS:
            ref = np.concatenate([getattr(p, k).cpu().numpy()
                                  for p in parts])
            assert out[k].dtype == ref.dtype, k
            np.testing.assert_array_equal(out[k], ref, err_msg=f"{v} {k}")
        assert np.isfinite(out["speed"]).all() and out["converged"].any()


def test_a_warm_call_pins_only_its_columns(cuda):
    """Once the staging buffers exist, a family call pins its columns and
    nothing else, and builds the family's operands once."""
    goals = _goals()
    kw = dict(iters=5, batch_per_device=CHUNK, device=cuda)
    solve_goal_lattice(2.0, goals, **kw)
    before = spans.counters()
    first = solve_goal_lattice(3.0, goals, **kw)
    moved = spans.since(before)
    columns = sum(a.nbytes for a in first.values())
    assert moved["lattice.pinned_bytes"] == columns == G * (4 + 4 + 1)
    assert moved["goal.operand_builds"] == 1
    assert moved["lattice.chunks"] == 3
    kept = {k: a.copy() for k, a in first.items()}
    solve_goal_lattice(4.0, goals, **kw)
    for k in COLUMNS:
        np.testing.assert_array_equal(first[k], kept[k], err_msg=k)
