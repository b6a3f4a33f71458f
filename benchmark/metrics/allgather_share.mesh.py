"""The share of rank 0's traced families' wall time in NCCL kernels, in %
(``readers.allgather_share``)."""

from benchmark.readers import allgather_share as read  # noqa: F401
