"""Vehicle dynamics: parameters, single-track and Frenet models, spirals."""

from irbfn_tpu_torch.dynamics.frenet import (
    FRENET_STATE_DIM,
    V_SWITCH,
    frenet_deriv,
    frenet_hs_deriv,
    frenet_ls_deriv,
    frenet_onestep,
    frenet_rollout,
    integrate_frenet,
    tire_forces,
)
from irbfn_tpu_torch.dynamics.params import (
    G,
    VehicleParams,
    as_params,
    f1tenth_params,
    fullscale_params,
)
from irbfn_tpu_torch.dynamics.single_track import (
    CONTROL_DIM,
    ST_STATE_DIM,
    V_BLEND,
    accl_constraint,
    blended_deriv,
    euler_step,
    integrate_st,
    kinematic_onestep,
    ks_deriv,
    ks_deriv_cr,
    rk4_step,
    rollout,
    st_deriv,
    st_deriv_cr,
    st_mixed_deriv,
    steer_constraint,
)
from irbfn_tpu_torch.dynamics.spiral import (
    N_PATH_POINTS,
    clothoid_to_params,
    curvature_theta,
    integrate_endpoint_gl,
    integrate_path,
    params_to_coefs,
    sample_path,
)

__all__ = [
    "G", "VehicleParams", "as_params", "f1tenth_params", "fullscale_params",
    "CONTROL_DIM", "ST_STATE_DIM", "V_BLEND", "accl_constraint",
    "blended_deriv", "euler_step", "integrate_st", "kinematic_onestep",
    "ks_deriv", "ks_deriv_cr", "rk4_step", "rollout", "st_deriv",
    "st_deriv_cr", "st_mixed_deriv", "steer_constraint", "FRENET_STATE_DIM",
    "V_SWITCH", "frenet_deriv", "frenet_hs_deriv", "frenet_ls_deriv",
    "frenet_onestep", "frenet_rollout", "integrate_frenet", "tire_forces",
    "N_PATH_POINTS", "clothoid_to_params", "curvature_theta",
    "integrate_endpoint_gl", "integrate_path", "params_to_coefs",
    "sample_path",
]
