"""The card's idle share of the traced control steps, in %
(``readers.idle_share``)."""

from benchmark.readers import idle_share as read  # noqa: F401
