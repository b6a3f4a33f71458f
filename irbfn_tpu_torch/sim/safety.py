"""Action modes between the planner and the integrator.

Port of the ``"accl"`` mode of ``irbfn_tpu/sim/safety.py``. The ``"speed"``
mode (the PID low-level controller) and the iTTC check are still to be
ported.
"""

from __future__ import annotations

import torch

from irbfn_tpu_torch.dynamics.params import VehicleParams


def accl_action(action, state, p: VehicleParams):
    """'accl' control mode: action (..., 2) = [accel, steer_vel] passes
    through (saturation happens inside the dynamics)."""
    del state, p
    return torch.as_tensor(action)


ACTION_MODES = {"accl": accl_action}
