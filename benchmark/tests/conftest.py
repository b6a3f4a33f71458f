"""The benchmark's own tests: on the CPU at small sizes, and on the card
(the ``cuda`` fixture skips without one)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes of each traffic mix for CPU runs
SMALL = {
    "closed_loop": {"mu": [0.5, 1.1, 2], "cs": [1.0, 10.0, 2], "trials": 3,
                    "episode_steps": 5, "check_steps": 8, "profile_steps": 2,
                    "warmup_steps": 1},
    "goal_lattice": {"grid": {"v_car": [-1.0, 8.0, 4.5],
                              "x_goal": [-1.2, 4.0, 1.3],
                              "y_goal": [0.0, 4.0, 1.0],
                              "t_goal": [-3.14, 3.14, 1.57],
                              "v_goal": [-1.0, 8.0, 3.0]},
                     "chunk": 300, "check_rows_per_family": 64,
                     "profile_families": 1},
}


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
