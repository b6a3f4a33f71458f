"""Planner layer: the learned Frenet and cartesian planners, the NMPC and
goal-MPC planners, the explicit table planners, the EXP3 bandit, and the
adaptive planners over a net bank with the online grip observer, and the
spiral lattice planner."""

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
from irbfn_tpu_torch.planning.lattice import (LatticePlan, LatticePlanner,
                                              plan_lattice,
                                              sample_lookahead_grid)
from irbfn_tpu_torch.planning.grip import (GripConfig, GripState, grip_init,
                                           grip_record, grip_update)
from irbfn_tpu_torch.planning.planner import (AdaptiveIRBFNPlanner,
                                              GripAdaptiveFrenetPlanner,
                                              IRBFNFrenetPlanner,
                                              IRBFNPlanner, NMPCPlanner,
                                              PlanResult, stack_net_bank)

__all__ = ["EXP3", "exp3_init", "exp3_probs", "exp3_pull", "exp3_update",
           "AdaptiveExplicitPlanner", "ExplicitFrenetPlanner", "GridTable",
           "NNTable", "grid_lookup", "grid_lookup_linear",
           "grid_table_from_arrays", "nn_lookup", "nn_table_from_arrays",
           "stack_grid_tables", "GoalMPCPlanner", "GripConfig", "GripState",
           "grip_init", "grip_record", "grip_update", "AdaptiveIRBFNPlanner",
           "GripAdaptiveFrenetPlanner", "IRBFNFrenetPlanner", "IRBFNPlanner",
           "NMPCPlanner", "PlanResult", "stack_net_bank", "LatticePlan",
           "LatticePlanner", "plan_lattice", "sample_lookahead_grid"]
