"""Planner layer: the learned Frenet planner and the goal-MPC planner."""

from irbfn_tpu_torch.planning.goal_planner import GoalMPCPlanner
from irbfn_tpu_torch.planning.planner import IRBFNFrenetPlanner, PlanResult

__all__ = ["GoalMPCPlanner", "IRBFNFrenetPlanner", "PlanResult"]
