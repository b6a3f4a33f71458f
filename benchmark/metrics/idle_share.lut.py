"""The card's idle share of the profiled pass, in %
(``readers.idle_share``)."""

from benchmark.readers import idle_share as read  # noqa: F401
