"""Kernel launches the host made per control step, counted in the
profiler's trace of the traced steps."""


def read(layer):
    tr = layer.get("trace")
    if not tr or not tr["units"] or not tr["launches"]:
        return None
    return tr["launches"] / tr["units"]
