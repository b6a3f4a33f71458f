"""Vehicle dynamics: parameters, single-track and Frenet models."""

from irbfn_tpu_torch.dynamics.frenet import (
    FRENET_STATE_DIM,
    V_SWITCH,
    frenet_deriv,
    frenet_hs_deriv,
    frenet_ls_deriv,
    frenet_rollout,
    tire_forces,
)
from irbfn_tpu_torch.dynamics.params import (
    G,
    VehicleParams,
    f1tenth_params,
    fullscale_params,
)
from irbfn_tpu_torch.dynamics.single_track import (
    CONTROL_DIM,
    ST_STATE_DIM,
    V_BLEND,
    blended_deriv,
    euler_step,
    ks_deriv,
    rk4_step,
    st_deriv,
)

__all__ = [
    "G", "VehicleParams", "f1tenth_params", "fullscale_params",
    "CONTROL_DIM", "ST_STATE_DIM", "V_BLEND", "blended_deriv", "euler_step",
    "ks_deriv", "rk4_step", "st_deriv", "FRENET_STATE_DIM", "V_SWITCH",
    "frenet_deriv", "frenet_hs_deriv", "frenet_ls_deriv", "frenet_rollout",
    "tire_forces",
]
