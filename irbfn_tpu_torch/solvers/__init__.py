"""Solvers: the goal-MPC condensed box QP (family, row and lattice solves,
the LTV tracker), batched ADMM QPs and the condensed linear MPC,
the batched AL/Newton NMPC solver and its host-side SLSQP oracle, the
clothoid G1-Hermite solver and batched Levenberg-Marquardt."""

from irbfn_tpu_torch.solvers.clothoid import (
    ClothoidSolution,
    solve_g1_hermite,
    solve_g1_lattice,
    wrap_angle,
)

from irbfn_tpu_torch.solvers.goal_mpc import (
    GoalMPCConfig,
    GoalMPCSolution,
    GoalQPFamily,
    condensed_family,
    solve_goal_family,
    solve_goal_lattice,
    solve_goal_mpc,
    solve_tracking_mpc,
)
from irbfn_tpu_torch.solvers.lm import LMResult, levenberg_marquardt
from irbfn_tpu_torch.solvers.qp import (
    LinearMPC,
    QPSolution,
    condense,
    double_integrator_mpc,
    solve_linear_mpc_batch,
    solve_qp_batch,
)
from irbfn_tpu_torch.solvers.nmpc import (
    NMPCConfig,
    NMPCSolution,
    cartesian_config,
    kinematic_config,
    solve_cartesian_point,
    solve_lattice_multi_params,
    solve_lattice_point,
    solve_nmpc_batch,
)

__all__ = ["ClothoidSolution", "solve_g1_hermite", "solve_g1_lattice",
           "wrap_angle", "LMResult", "levenberg_marquardt",
           "GoalMPCConfig", "GoalMPCSolution", "GoalQPFamily",
           "condensed_family", "solve_goal_family", "solve_goal_lattice",
           "solve_goal_mpc", "solve_tracking_mpc", "NMPCConfig", "NMPCSolution",
           "cartesian_config", "kinematic_config", "solve_cartesian_point",
           "solve_lattice_multi_params", "solve_lattice_point",
           "solve_nmpc_batch", "LinearMPC", "QPSolution", "condense",
           "double_integrator_mpc", "solve_linear_mpc_batch",
           "solve_qp_batch"]
