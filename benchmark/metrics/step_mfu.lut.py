"""The profiled passes' counted float32 work (``counts.rbf_forward_ops``
of every goal of the grid at the net's widths) over their wall time, as
a share of one card's float32 peak (``peaks.json``), in %."""

from benchmark import counts


def read(layer):
    tr = layer.get("trace")
    if not tr or "pass_flops" not in layer:
        return None
    return (100.0 * layer["pass_flops"] * tr["units"]
            / (tr["window_s"] * counts.PEAKS["f32_flops_per_s"]))
