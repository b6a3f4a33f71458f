"""The simulator's share of a control step: ``TrackEnv.observe`` plus
``TrackEnv.step``, each a synchronised span; the median over the window's
steps, in ms."""

import numpy as np


def read(layer):
    spans = layer.get("spans", {})
    obs, step = spans.get("bench.observe"), spans.get("bench.env_step")
    if not obs or not step:
        return None
    return 1e3 * float(np.median(np.asarray(obs) + np.asarray(step)))
