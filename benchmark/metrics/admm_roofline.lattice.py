"""The ADMM kernel's share of its roofline on one card, in %
(``readers.admm_roofline``)."""

from benchmark.readers import admm_roofline as read  # noqa: F401
