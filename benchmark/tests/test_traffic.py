"""Every generator repeats by seed, and seeds change draws, not sizes."""

import numpy as np
import torch

from benchmark import traffic
from benchmark.reference import keys


def test_episode_keys_repeat_by_seed_and_match_the_sweeps_chain():
    """The reference's key chain is the one ``eval_closed_loop`` draws its
    episodes from: the same keys, bit for bit, and the same normal draws to
    the program's float32 rounding."""
    from irbfn_tpu_torch.utils import prng

    big = 2**31 + 12345
    ref = keys.episode_keys(big, 3)
    key = prng.PRNGKey(big)
    for want in ref:
        key, sub = prng.split(key)
        assert np.array_equal(sub.numpy().astype(np.uint64), want)
    z = keys.normal(ref[2], (500, 3))
    assert z.shape == (500, 3)
    prog = prng.normal(torch.as_tensor(ref[2].astype(np.int64)), (500, 3))
    assert np.abs(prog.double().numpy() - z).max() < 1e-5
    assert np.array_equal(z, keys.normal(keys.episode_keys(big, 3)[2],
                                         (500, 3)))
    assert not np.array_equal(keys.episode_keys(big + 1, 1)[0], ref[0])


def test_family_order_repeats_by_seed():
    a = traffic.family_order(19, 2**33 + 1)
    assert np.array_equal(a, traffic.family_order(19, 2**33 + 1))
    assert sorted(a.tolist()) == list(range(19))
    assert not np.array_equal(a, traffic.family_order(19, 2**33 + 2))


def test_sweep_lanes():
    mu, cs = traffic.sweep_lanes({"mu": [0.5, 1.1, 10], "cs": [1.0, 10.0, 10],
                                  "trials": 10})
    assert mu.size == cs.size == 1000
    assert mu[0] == 0.5 and mu[-1] == 1.1 and cs[9] == 1.0 and cs[10] == 2.0
