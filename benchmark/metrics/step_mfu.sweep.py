"""A control step's counted float32 work (``counts.control_step_flops``:
projections, the planner's forward and prediction, the simulator's RK4
steps) over the step's wall time in the traced window, as a share of the
card's float32 peak (``peaks.json``), in %."""

from benchmark import counts


def read(layer):
    if "step_flops" not in layer or not layer.get("steps"):
        return None
    per_step = layer["window_s"] / layer["steps"]
    return (100.0 * layer["step_flops"] / per_step
            / counts.PEAKS["f32_flops_per_s"])
