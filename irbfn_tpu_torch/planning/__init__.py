"""Planner layer: the learned Frenet planner, the NMPC and goal-MPC planners,
the explicit table planners and the EXP3 bandit."""

from irbfn_tpu_torch.planning.bandits import (EXP3, exp3_init, exp3_probs,
                                              exp3_pull, exp3_update)
from irbfn_tpu_torch.planning.explicit import (
    AdaptiveExplicitPlanner,
    ExplicitFrenetPlanner,
    GridTable,
    NNTable,
    grid_lookup,
    grid_lookup_linear,
    grid_table_from_arrays,
    nn_lookup,
    nn_table_from_arrays,
    stack_grid_tables,
)
from irbfn_tpu_torch.planning.goal_planner import GoalMPCPlanner
from irbfn_tpu_torch.planning.planner import (IRBFNFrenetPlanner,
                                              NMPCPlanner, PlanResult)

__all__ = ["EXP3", "exp3_init", "exp3_probs", "exp3_pull", "exp3_update",
           "AdaptiveExplicitPlanner", "ExplicitFrenetPlanner", "GridTable",
           "NNTable", "grid_lookup", "grid_lookup_linear",
           "grid_table_from_arrays", "nn_lookup", "nn_table_from_arrays",
           "stack_grid_tables", "GoalMPCPlanner", "IRBFNFrenetPlanner",
           "NMPCPlanner", "PlanResult"]
