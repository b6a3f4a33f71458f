"""Lattice data generation on one device, and the goal-MPC table generator
(``python -m irbfn_tpu_torch.parallel.gen_goal_mpc_table``)."""

from irbfn_tpu_torch.parallel.datagen import (
    GridSpec,
    build_lattice,
    controls_block,
    solve_lattice,
)

__all__ = ["GridSpec", "build_lattice", "controls_block",
           "solve_lattice"]
