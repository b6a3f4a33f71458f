"""Simulator layer: track, Frenet frame, closed-loop env."""

from irbfn_tpu_torch.sim.env import (
    Observation,
    SimState,
    StepRecord,
    TrackEnv,
    deviation_metrics,
)
from irbfn_tpu_torch.sim.safety import (
    ACTION_MODES,
    accl_action,
    pid_lowlevel,
    speed_action,
)
from irbfn_tpu_torch.sim.track import (
    Raceline,
    Track,
    cartesian_to_frenet,
    frenet_to_cartesian,
    from_control_points,
    from_csv,
    horizon_goal_speed,
    interp_wrapped,
    oval_track,
    wrap_angle,
)

__all__ = [
    "Observation", "SimState", "StepRecord", "TrackEnv", "deviation_metrics",
    "ACTION_MODES", "accl_action", "pid_lowlevel", "speed_action",
    "Raceline", "Track",
    "cartesian_to_frenet", "frenet_to_cartesian", "from_control_points",
    "from_csv", "horizon_goal_speed", "interp_wrapped", "oval_track",
    "wrap_angle",
]
