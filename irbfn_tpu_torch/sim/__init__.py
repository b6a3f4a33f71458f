"""Simulator layer: track, Frenet frame, occupancy maps and lidar, closed-loop
env."""

from irbfn_tpu_torch.sim.env import (
    Observation,
    SimState,
    StepRecord,
    TrackEnv,
    deviation_metrics,
    observation_factory,
)
from irbfn_tpu_torch.sim.map import (
    OccupancyMap,
    ScanSpec,
    distance_at,
    footprint_clearance,
    from_bitmap,
    load_map_yaml,
    load_track_bundle,
    map_clearance,
    raceline_from_csv,
    rasterize_track,
    save_map_yaml,
    trace_rays,
)
from irbfn_tpu_torch.sim.safety import (
    ACTION_MODES,
    accl_action,
    beam_geometry,
    pid_lowlevel,
    speed_action,
    ttc_in_collision,
)
from irbfn_tpu_torch.sim.track import (
    Raceline,
    Track,
    cartesian_to_frenet,
    centerline_from_arrays,
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
    "observation_factory",
    "OccupancyMap", "ScanSpec", "distance_at", "footprint_clearance",
    "from_bitmap", "load_map_yaml", "load_track_bundle", "map_clearance",
    "raceline_from_csv", "rasterize_track", "save_map_yaml", "trace_rays",
    "ACTION_MODES", "accl_action", "beam_geometry", "pid_lowlevel",
    "speed_action", "ttc_in_collision",
    "Raceline", "Track", "cartesian_to_frenet", "centerline_from_arrays",
    "frenet_to_cartesian", "from_control_points",
    "from_csv", "horizon_goal_speed", "interp_wrapped", "oval_track",
    "wrap_angle",
]
