"""The share of the profiled pass's wall time in which the card sat idle
while the host was inside a ``lattice.*`` span of the port, in %
(``program.pipeline_idle_share``); None for a program whose pass opens no
such span."""

from benchmark.program import pipeline_idle_share as read  # noqa: F401
