"""The general generator: every input a cell's traffic file describes, made
from ``--seed`` and the file's parameters alone. Every seed gives the same
sizes; only the draws differ.

The closed loop's episode starts come from the key chain the sweep itself
draws them from (``key, sub = split(key)`` an episode, rooted at the seed),
which gives the same draws on every device. The other draws are NumPy
streams, numbered so that a draw for one purpose never shifts another:
1 the order of the lattice's families, 2 the rows a check samples.
"""

from __future__ import annotations

import numpy as np

FAMILY_ORDER, CHECK_SAMPLE = 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


def linspace(spec) -> np.ndarray:
    """``[lo, hi, num]`` -> ``linspace(lo, hi, num)``."""
    lo, hi, num = spec
    return np.linspace(lo, hi, int(num))


def sweep_lanes(t: dict):
    """Per-lane (mu, cs), float64: the (mu x cs) grid, ``trials`` lanes each,
    mu the slower axis."""
    mus, css = linspace(t["mu"]), linspace(t["cs"])
    mu, cs = np.meshgrid(mus, css, indexing="ij")
    n = int(t["trials"])
    return np.repeat(mu.reshape(-1), n), np.repeat(cs.reshape(-1), n)


def family_order(n_families: int, seed: int) -> np.ndarray:
    return rng(seed, FAMILY_ORDER).permutation(n_families)
