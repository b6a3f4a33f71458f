"""The RBF forward kernel's share of its roofline over the profiled pass, in
%: the least time the card could take (``counts.roofline_seconds``) for
the rows the kernel ran there (the port's ``ops.rbf.rows`` counter) at the
net's widths, each launch reading the net's operands once
(``counts.rbf_forward_*``), over the device time of the kernels whose names
hold ``rbf``. None where the program counts no rows (a program without the
counter, or no launch)."""

from benchmark import counts


def read(layer):
    rows, dev = layer.get("rbf_rows"), layer.get("rbf_kernel_s")
    if not rows or not dev or not layer.get("rbf_forwards"):
        return None
    R, K, F, O = layer["dims"]
    ops = counts.rbf_forward_ops(rows, R, K, F, O)
    # bytes are linear in the rows plus the operands a launch reads once
    nbytes = (counts.rbf_forward_bytes(rows, R, K, F, O)
              + (layer["rbf_forwards"] - 1)
              * counts.rbf_forward_bytes(0, R, K, F, O))
    return 100.0 * counts.roofline_seconds(ops, nbytes) / dev
