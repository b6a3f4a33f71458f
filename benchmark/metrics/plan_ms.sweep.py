"""``IRBFNFrenetPlanner.plan_batch``, a synchronised span; the median over
the window's steps, in ms."""

import numpy as np


def read(layer):
    plan = layer.get("spans", {}).get("bench.plan")
    if not plan:
        return None
    return 1e3 * float(np.median(plan))
