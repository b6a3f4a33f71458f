"""Solvers: the goal-MPC condensed box QP (family, row and lattice solves)."""

from irbfn_tpu_torch.solvers.goal_mpc import (
    GoalMPCConfig,
    GoalMPCSolution,
    GoalQPFamily,
    condensed_family,
    solve_goal_family,
    solve_goal_lattice,
    solve_goal_mpc,
)

__all__ = ["GoalMPCConfig", "GoalMPCSolution", "GoalQPFamily",
           "condensed_family", "solve_goal_family", "solve_goal_lattice",
           "solve_goal_mpc"]
