"""The ADMM kernel's share of its roofline on the mesh's rank 0, in %
(``readers.admm_roofline``)."""

from benchmark.readers import admm_roofline as read  # noqa: F401
