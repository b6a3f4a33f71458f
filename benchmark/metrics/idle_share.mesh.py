"""The cards' idle share of the traced families on the 4-rank mesh, in %
(``readers.idle_share``)."""

from benchmark.readers import idle_share as read  # noqa: F401
