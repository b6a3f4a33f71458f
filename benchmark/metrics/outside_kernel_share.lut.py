"""The share of the profiled pass's wall time in which no RBF kernel ran:
the staging and copies of the lattice chunk loop, its drains and the
host's own work, in %."""


def read(layer):
    tr, dev = layer.get("trace"), layer.get("rbf_kernel_s")
    if not tr or not dev:
        return None
    return 100.0 * (1.0 - dev / tr["window_s"])
