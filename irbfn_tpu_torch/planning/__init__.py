"""Planner layer: the learned Frenet planner."""

from irbfn_tpu_torch.planning.planner import IRBFNFrenetPlanner, PlanResult

__all__ = ["IRBFNFrenetPlanner", "PlanResult"]
