"""The traced families' counted work over their wall time at one card's float32
peak, in % (``readers.lattice_mfu``)."""

from benchmark.readers import lattice_mfu as read  # noqa: F401
