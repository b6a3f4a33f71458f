"""The traced families' counted work over their wall time at four cards'
float32 peak, in % (``readers.lattice_mfu``)."""

from benchmark.readers import lattice_mfu as read  # noqa: F401
