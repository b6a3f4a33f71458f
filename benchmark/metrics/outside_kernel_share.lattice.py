"""The share of a family's wall time outside the ADMM kernel on one card, in %
(``readers.outside_kernel_share``)."""

from benchmark.readers import outside_kernel_share as read  # noqa: F401
