"""PyTorch port of ``ops/geometry.py`` and ``sim/track.py:
centerline_from_arrays`` vs the JAX package.

The six cases of ``tests/test_geometry.py`` run through both packages in
f64, plus seeded batches: nearest points to 1e-12 with equal segment
indices, circle intersections to 1e-12 (forward and wrapped searches, and a
miss), the rotation matrix and the [0, 2*pi) wrap to 1e-15. Tracks from
centerline arrays are built on the host in f64 and cast to f32 by both
packages: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.ops import geometry as jgeo
from irbfn_tpu.sim import track as jtrack
from irbfn_tpu_torch.ops import geometry as tgeo
from irbfn_tpu_torch.sim import track as ttrack

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)


def _poly():
    t = np.linspace(0, 2 * np.pi, 50, endpoint=False)
    return np.stack([10 * np.cos(t), 5 * np.sin(t)], axis=-1)


def _line():
    return np.stack([np.linspace(-5, 5, 21), np.zeros(21)], axis=-1)


def _both(fn_name, *args, **kw):
    j = getattr(jgeo, fn_name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args), **kw)
    t = getattr(tgeo, fn_name)(*(torch.from_numpy(a)
                                 if isinstance(a, np.ndarray) else a
                                 for a in args), **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


# (trajectory, point): the nearest-point cases of tests/test_geometry.py
NEAREST = {
    "on_segment": (np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 10.0]]),
                   np.array([5.0, 3.0])),
    "clamps_to_vertex": (np.array([[0.0, 0.0], [10.0, 0.0]]),
                         np.array([12.0, 1.0])),
    "batched": (_poly(), np.random.default_rng(0).normal(size=(16, 2)) * 3),
    "seeded_batch": (_poly(),
                     np.random.default_rng(1).normal(size=(7, 33, 2)) * 8),
}


@pytest.mark.parametrize("case", sorted(NEAREST))
def test_torch_nearest_point_matches_jax(case):
    traj, pt = NEAREST[case]
    j, t = _both("nearest_point", pt, traj)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(t[3], j[3])
    if case == "on_segment":
        np.testing.assert_allclose(t[0], [5.0, 0.0], atol=1e-12)
        assert float(t[1]) == pytest.approx(3.0) and int(t[3]) == 0


# (point, radius, trajectory, t, wrap): the intersection cases of
# tests/test_geometry.py (crossing, forward search, miss) and wrapped ones
INTERSECT = {
    "circle_crossing": (np.array([0.0, 0.0]), 2.0, _line(), 0.0, False),
    "forward_search": (np.array([0.0, 0.0]), 2.0, _line(), 10.0, False),
    "no_hit": (np.array([0.0, 0.0]), 1.0,
               np.array([[10.0, 10.0], [11.0, 10.0]]), 0.0, False),
    "wrap_from_end": (np.array([9.5, 1.5]), 2.0, _poly(), 48.3, True),
    "wrap_mid": (np.array([0.3, -4.6]), 1.2, _poly(), 37.0, True),
    "forward_mid_fraction": (np.array([-9.8, 0.5]), 1.5, _poly(), 24.6,
                             False),
}


@pytest.mark.parametrize("case", sorted(INTERSECT))
def test_torch_intersect_point_matches_jax(case):
    pt, r, traj, t0, wrap = INTERSECT[case]
    j, t = _both("intersect_point", pt, r, traj, t=t0, wrap=wrap)
    np.testing.assert_allclose(t[0], j[0], equal_nan=True, **TOL)
    assert int(t[1]) == int(j[1])
    np.testing.assert_allclose(t[2], j[2], equal_nan=True, **TOL)
    if case == "circle_crossing":
        np.testing.assert_allclose(t[0], [-2.0, 0.0], atol=1e-5)
    if case == "forward_search":
        np.testing.assert_allclose(t[0][0], 2.0, atol=1e-5)
    if case == "no_hit":
        assert int(t[1]) == -1 and np.isnan(t[0]).all()


def test_torch_rotation_and_wrap_match_jax():
    theta = np.random.default_rng(2).uniform(-20.0, 20.0, (5, 9))
    np.testing.assert_allclose(
        tgeo.rotation_matrix(torch.from_numpy(theta)).numpy(),
        np.asarray(jgeo.rotation_matrix(jnp.asarray(theta))), rtol=0,
        atol=1e-15)
    np.testing.assert_allclose(
        tgeo.zero_to_2pi(torch.from_numpy(theta)).numpy(),
        np.asarray(jgeo.zero_to_2pi(jnp.asarray(theta))), rtol=0, atol=1e-14)
    r = tgeo.rotation_matrix(torch.tensor(0.3, dtype=torch.float64))
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(2), atol=1e-15)


@pytest.mark.parametrize("n_pts", [40, 400])
def test_torch_centerline_from_arrays_bit_equal(n_pts):
    t = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
    xs, ys = 20 * np.cos(t) + np.sin(3 * t), 9 * np.sin(t)
    j = jtrack.centerline_from_arrays(xs, ys, speed=5.0)
    tt = ttrack.centerline_from_arrays(xs, ys, speed=5.0, device="cpu")
    assert tt.raceline.n_points == max(1024, 4 * n_pts)
    for a, b in zip(tt.raceline, j.raceline):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
