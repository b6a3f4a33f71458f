"""irbfn_tpu_torch — the PyTorch + CUDA port of ``irbfn_tpu``.

The learned-planner serving path runs here: the WCRBF net (its forward is
one hand-written Hopper kernel, ``ops/csrc/rbf_forward.cu``, on CUDA
tensors), the Frenet planner, and the batched closed-loop simulator. Each
subpackage mirrors the JAX package's layout and function names:

- ``irbfn_tpu_torch.dynamics`` — vehicle parameters, single-track and
  Frenet dynamics.
- ``irbfn_tpu_torch.models``   — the basis registry and ``WCRBFNet``.
- ``irbfn_tpu_torch.ops``      — the fused RBF forward and the goal-family
  ADMM solve (CUDA kernels and their plain PyTorch versions).
- ``irbfn_tpu_torch.parallel`` — lattice generation on one device and the
  goal-MPC table generator.
- ``irbfn_tpu_torch.planning`` — ``IRBFNFrenetPlanner``, ``GoalMPCPlanner``.
- ``irbfn_tpu_torch.sim``      — track, Frenet frame, ``TrackEnv``.
- ``irbfn_tpu_torch.solvers``  — the goal-MPC condensed box QP.
- ``irbfn_tpu_torch.train``    — config and weights from JSON + numpy.

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
