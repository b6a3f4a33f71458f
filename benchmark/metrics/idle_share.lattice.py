"""The card's idle share of the traced families on one card, in %
(``readers.idle_share``)."""

from benchmark.readers import idle_share as read  # noqa: F401
