"""Bodies that several per-layer metrics share: each metric's file under
``metrics/`` names one of these as its ``read``, so one quantity read in
cells that report different end-to-end metrics keeps one arithmetic. Each
returns None where the layer holds nothing to read."""

from __future__ import annotations

from benchmark import counts


def idle_share(layer):
    """The share of the traced stretch's wall time in which no kernel ran
    (1 - busy / wall, busy averaged over the cards used), in %."""
    tr = layer.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def admm_roofline(layer):
    """The ADMM kernel's share of its roofline on rank 0: the least time
    the card could take for its rows' counted sweeps (``counts.admm_*``:
    2,744 operations a row and sweep at horizon 8) and bytes, against
    ``peaks.json``, over the kernel's device time in the trace, in %."""
    dev = layer.get("admm_kernel_s")
    if not dev or "admm_ops_bytes" not in layer:
        return None
    ops, nbytes = layer["admm_ops_bytes"]
    return 100.0 * counts.roofline_seconds(ops, nbytes) / dev


def outside_kernel_share(layer):
    """The share of rank 0's traced families' wall time in which the ADMM
    kernel did not run: condensing, the host pipeline's copies, the gather
    and the host's own work, in %."""
    tr, dev = layer.get("trace"), layer.get("admm_kernel_s")
    if not tr or not dev:
        return None
    return 100.0 * (1.0 - dev / tr["window_s"])


def lattice_mfu(layer):
    """The traced families' counted float32 work (``counts.
    lattice_family_flops``: every row's linear term and ADMM sweeps) over
    their wall time, as a share of the float32 peak of the cards used, in
    %."""
    tr = layer.get("trace")
    if not tr or "family_flops" not in layer:
        return None
    peak = counts.PEAKS["f32_flops_per_s"] * layer["chips"]
    return (100.0 * layer["family_flops"] * tr["units"]
            / (tr["window_s"] * peak))


def allgather_share(layer):
    """The share of rank 0's traced families' wall time spent in NCCL
    kernels (``solve_lattice_sharded``'s gather of each chunk's columns),
    in %."""
    tr, dev = layer.get("trace"), layer.get("nccl_kernel_s")
    if not tr or not dev:
        return None
    return 100.0 * dev / tr["window_s"]
