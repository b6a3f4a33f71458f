"""PyTorch port of the vehicle dynamics vs the JAX package, in f64.

The same numpy-drawn states, controls and per-lane parameters go through
``irbfn_tpu.dynamics`` and ``irbfn_tpu_torch.dynamics``. Both run the same
f64 arithmetic, so they agree to ~1e-12 (transcendental functions of the
two libraries may differ in the last ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics import frenet as jfr
from irbfn_tpu.dynamics import params as jpar
from irbfn_tpu.dynamics import single_track as jst
from irbfn_tpu_torch.dynamics import frenet as tfr
from irbfn_tpu_torch.dynamics import params as tpar
from irbfn_tpu_torch.dynamics import single_track as tst

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)
B = 64


def _params(rng):
    """Per-lane (mu, cs, dt) around the f1tenth car, for both packages."""
    mu = rng.uniform(0.5, 1.1, B)
    cs = rng.uniform(1.0, 10.0, B)
    dt = rng.uniform(0.005, 0.02, B)
    base = np.asarray(jpar.f1tenth_params(dtype=jnp.float64).to_vector())
    vec = np.tile(base, (B, 1))
    vec[:, 0], vec[:, 5], vec[:, 6], vec[:, 8] = mu, cs, cs, dt
    return (jpar.VehicleParams.from_vector(jnp.asarray(vec)),
            tpar.VehicleParams.from_vector(torch.from_numpy(vec)))


def _st_inputs(rng):
    # speeds on both sides of the kinematic/dynamic blend and near 0,
    # steering and controls partly past their limits (exercises the clips)
    x = np.stack([rng.normal(0, 5, B), rng.normal(0, 5, B),
                  rng.uniform(-0.5, 0.5, B), rng.uniform(-0.01, 8.0, B),
                  rng.uniform(-np.pi, np.pi, B), rng.normal(0, 1, B),
                  rng.normal(0, 0.2, B)], axis=-1)
    u = np.stack([rng.uniform(-12, 12, B), rng.uniform(-4, 4, B)], axis=-1)
    return x, u


def _fr_inputs(rng):
    x = np.stack([rng.uniform(0, 80, B), rng.uniform(-1.5, 1.5, B),
                  rng.uniform(-0.5, 0.5, B), rng.uniform(0.2, 8.0, B),
                  rng.normal(0, 0.5, B), rng.normal(0, 1.5, B),
                  rng.uniform(-0.8, 0.8, B)], axis=-1)
    u = np.stack([rng.uniform(-12, 12, B), rng.uniform(-4, 4, B)], axis=-1)
    curv = rng.uniform(-0.45, 0.45, B)
    return x, u, curv


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_torch_params_constants():
    for name in ("f1tenth_params", "fullscale_params"):
        j = getattr(jpar, name)(mu=0.7, cs=4.0, dt=0.05, dtype=jnp.float64)
        t = getattr(tpar, name)(mu=0.7, cs=4.0, dt=0.05, dtype=torch.float64,
                                device="cpu")
        _close(t.to_vector(), j.to_vector())
        assert float(t.wheelbase) == float(j.wheelbase)
    assert tpar.G == jpar.G
    p = tpar.f1tenth_params(device="cpu").to(dtype=torch.float64)
    assert p.dtype == torch.float64 and p.mu.dtype == torch.float64


@pytest.mark.parametrize("name", ["st_deriv", "ks_deriv", "blended_deriv"])
def test_torch_single_track_derivs(name):
    rng = np.random.default_rng(0)
    pj, pt = _params(rng)
    x, u = _st_inputs(rng)
    j = getattr(jst, name)(jnp.asarray(x), jnp.asarray(u), pj)
    t = getattr(tst, name)(torch.from_numpy(x), torch.from_numpy(u), pt)
    _close(t, j)


@pytest.mark.parametrize("step", ["euler_step", "rk4_step"])
def test_torch_single_track_steps_per_lane_dt(step):
    rng = np.random.default_rng(1)
    pj, pt = _params(rng)
    x, u = _st_inputs(rng)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for _ in range(10):  # ten substeps, as the simulator takes them
        xj = getattr(jst, step)(jst.blended_deriv, xj, jnp.asarray(u), pj)
        xt = getattr(tst, step)(tst.blended_deriv, xt, torch.from_numpy(u),
                                pt)
    _close(xt, xj)


def test_torch_tire_forces():
    rng = np.random.default_rng(2)
    pj, pt = _params(rng)
    x, _, _ = _fr_inputs(rng)
    x[:4, 3] = [0.0, 5e-4, -5e-4, 1e-3]  # the vx ~ 0 guard
    args = [x[:, i] for i in (2, 3, 4, 5)]
    fj = jfr.tire_forces(*map(jnp.asarray, args), pj)
    ft = tfr.tire_forces(*map(torch.from_numpy, args), pt)
    for a, b in zip(ft, fj):
        _close(a, b)


@pytest.mark.parametrize("blend", ["switch", "ls", "hs"])
@pytest.mark.parametrize("saturate", [True, False])
def test_torch_frenet_deriv(blend, saturate):
    rng = np.random.default_rng(3)
    pj, pt = _params(rng)
    x, u, curv = _fr_inputs(rng)
    x[:8, 3] = rng.uniform(0.1, 1.2, 8)  # both sides of V_SWITCH
    j = jfr.frenet_deriv(jnp.asarray(x), jnp.asarray(u), jnp.asarray(curv),
                         pj, blend=blend, saturate=saturate)
    t = tfr.frenet_deriv(torch.from_numpy(x), torch.from_numpy(u),
                         torch.from_numpy(curv), pt, blend=blend,
                         saturate=saturate)
    _close(t, j)


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_torch_frenet_rollout(integrator):
    """The planner's 5-step rollout: scalar params, per-row curvature."""
    rng = np.random.default_rng(4)
    x, _, curv = _fr_inputs(rng)
    controls = np.stack([rng.uniform(-9, 9, (B, 5)),
                         rng.uniform(-3, 3, (B, 5))], axis=-1)
    pj = jpar.f1tenth_params(dtype=jnp.float64)
    pt = tpar.f1tenth_params(dtype=torch.float64, device="cpu")
    j = jfr.frenet_rollout(jnp.asarray(x), jnp.asarray(controls),
                           jnp.asarray(curv), pj, blend="ls",
                           integrator=integrator)
    t = tfr.frenet_rollout(torch.from_numpy(x), torch.from_numpy(controls),
                           torch.from_numpy(curv), pt, blend="ls",
                           integrator=integrator)
    assert t.shape == (B, 5, 7)
    _close(t, j)
