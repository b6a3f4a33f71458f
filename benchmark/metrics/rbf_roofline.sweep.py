"""The RBF forward kernel's share of its roofline: the least time the card
could take for the forward's counted operations and bytes
(``counts.rbf_forward_*``, against ``peaks.json``), over the kernel's
device time per forward in the trace (one forward per control step), in
%."""

from benchmark import counts
from benchmark.trace import kernel_seconds


def read(layer):
    tr = layer.get("trace")
    if not tr or "rbf_ops_bytes" not in layer:
        return None
    dev = kernel_seconds(tr, "rbf")
    if not dev:
        return None
    ops, nbytes = layer["rbf_ops_bytes"]
    return 100.0 * counts.roofline_seconds(ops, nbytes) / (dev / tr["units"])
