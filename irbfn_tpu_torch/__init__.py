"""irbfn_tpu_torch — the PyTorch + CUDA port of ``irbfn_tpu``.

The learned-planner serving path runs here (the WCRBF net, whose no-grad
forward is one hand-written Hopper kernel, ``ops/csrc/rbf_forward.cu``, on
CUDA tensors; the Frenet planner; the batched closed-loop simulator), the
goal-MPC path (table generation and the planner, on the ADMM kernel), and
the fit-and-train path that makes the nets (closed-form per-region fit,
Adam trainer and losses, checkpoints), and the Frenet table path (the
batched NMPC solver, the tiered table generator, the planners that read its
tables). Each subpackage mirrors the JAX package's layout and function
names:

- ``irbfn_tpu_torch.dynamics`` — vehicle parameters, single-track and
  Frenet dynamics, spirals.
- ``irbfn_tpu_torch.models``   — the basis registry, the four model classes
  and the closed-form fit (``models/fit.py``).
- ``irbfn_tpu_torch.ops``      — the fused RBF forward and the goal-family
  ADMM solve (CUDA kernels and their plain PyTorch versions).
- ``irbfn_tpu_torch.parallel`` — lattice generation on one device and the
  goal-MPC and Frenet NMPC table generators.
- ``irbfn_tpu_torch.planning`` — ``IRBFNFrenetPlanner``, ``NMPCPlanner``,
  ``GoalMPCPlanner``, the explicit table planners, the EXP3 bandit.
- ``irbfn_tpu_torch.sim``      — track, Frenet frame, ``TrackEnv``, and the
  closed-loop robustness sweep (``python -m ...sim.eval_closed_loop``).
- ``irbfn_tpu_torch.solvers``  — the goal-MPC condensed box QP, the batched
  AL/Newton NMPC solver and its SLSQP oracle.
- ``irbfn_tpu_torch.train``    — losses, the trainer, checkpoints as JSON +
  numpy files, clustering, and the ``python -m`` entry points
  ``train_goal_mpc``, ``eval_goal_mpc``, ``train_frenet``, ``eval_offline``.
- ``irbfn_tpu_torch.utils``    — flag groups, the metric logger, profiling.

Float32 matrix products run in full f32 wherever the port runs: the
closed-form heads carry large cancelling coefficients that TF32 would
corrupt, so both TF32 switches are turned off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from irbfn_tpu_torch import (  # noqa: E402,F401
    dynamics,
    models,
    ops,
    parallel,
    planning,
    sim,
    solvers,
    train,
)

__version__ = "0.1.0"
