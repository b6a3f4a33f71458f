"""The share of a family's wall time outside the ADMM kernel on the mesh's rank
0, in % (``readers.outside_kernel_share``)."""

from benchmark.readers import outside_kernel_share as read  # noqa: F401
