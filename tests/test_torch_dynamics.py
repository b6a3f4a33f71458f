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
from irbfn_tpu.dynamics import spiral as jsp
from irbfn_tpu_torch.dynamics import frenet as tfr
from irbfn_tpu_torch.dynamics import params as tpar
from irbfn_tpu_torch.dynamics import single_track as tst
from irbfn_tpu_torch.dynamics import spiral as tsp

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


# ------------------------------------- the rest of single_track and frenet

def _cr_inputs(rng):
    """States on both sides of the CommonRoad switches (v_low = 0.5, the
    wheel-spin speed 7.319, the boxes' edges) and controls past the limits."""
    x, u = _st_inputs(rng)
    x[:8, 3] = [0.0, 0.3, -0.3, 0.5, 7.0, 7.4, 9.0, -7.0]
    x[8:12, 2] = [0.4189, -0.4189, 0.5, -0.5]  # at and past the steer box
    u[8:12, 1] = [1.0, -1.0, -1.0, 1.0]
    return x, u


@pytest.mark.parametrize("name", ["st_deriv_cr", "ks_deriv_cr",
                                  "st_mixed_deriv"])
def test_torch_single_track_cr_and_mixed_derivs(name):
    rng = np.random.default_rng(5)
    pj, pt = _params(rng)
    x, u = _cr_inputs(rng)
    j = getattr(jst, name)(jnp.asarray(x), jnp.asarray(u), pj)
    t = getattr(tst, name)(torch.from_numpy(x), torch.from_numpy(u), pt)
    _close(t, j)


def test_torch_cr_constraints():
    rng = np.random.default_rng(6)
    pj, pt = _params(rng)
    v = rng.uniform(-8.0, 9.0, B)
    v[:4] = [7.0, -7.0, 7.319, 8.0]
    a = rng.uniform(-12.0, 12.0, B)
    d = rng.uniform(-0.5, 0.5, B)
    d[:2] = [0.4189, -0.4189]
    sv = rng.uniform(-4.0, 4.0, B)
    _close(tst.accl_constraint(torch.from_numpy(v), torch.from_numpy(a), pt),
           jst.accl_constraint(jnp.asarray(v), jnp.asarray(a), pj))
    _close(tst.accl_constraint(torch.from_numpy(v), torch.from_numpy(a), pt,
                               v_switch=5.0, v_min=-2.0),
           jst.accl_constraint(jnp.asarray(v), jnp.asarray(a), pj,
                               v_switch=5.0, v_min=-2.0))
    _close(tst.steer_constraint(torch.from_numpy(d), torch.from_numpy(sv),
                                pt),
           jst.steer_constraint(jnp.asarray(d), jnp.asarray(sv), pj))
    _close(tst.steer_constraint(torch.from_numpy(d), torch.from_numpy(sv),
                                pt, s_min=-0.2, sv_min=-1.0),
           jst.steer_constraint(jnp.asarray(d), jnp.asarray(sv), pj,
                                s_min=-0.2, sv_min=-1.0))


# the published CommonRoad unit-test vectors (the TUM vehicle-models
# benchmark's full-size test vehicle), as tests/test_dynamics_oracle.py
# holds the JAX package to them; control order here is [accl, sv]
_FT = 0.3048
_CR_VEC = [1.0489, 4.4482216152605 / _FT * 74.91452,
           4.4482216152605 * _FT * 1321.416, _FT * 3.793293, _FT * 4.667707,
           21.92 / 1.0489, 21.92 / 1.0489, _FT * 2.01355, 1e-2, 0.4, 11.5,
           1.066, 50.8]


@pytest.mark.parametrize("name,x,expected", [
    ("st_deriv_cr",
     [2.0233348142065677, 0.0041907137716636, 0.0197545248559617,
      15.7216236334290116, 0.0025857914776859, 0.0529001056654038,
      0.0033012170610298],
     [15.7213512030862397, 0.0925527979719355, 0.1500000000000000,
      5.3536773276413925, 0.0529001056654038, 0.6435589397748606,
      0.0313297971641291]),
    ("ks_deriv_cr",
     [3.9579422297936526, 0.0391650102771405, 0.0378491427211811,
      16.3546957860883566, 0.0294717351052816, 0.0, 0.0],
     [16.3475935934250209, 0.4819314886013121, 0.1500000000000000,
      5.1464424102339752, 0.2401426578627629, 0.0, 0.0]),
])
def test_torch_published_commonroad_vectors(name, x, expected):
    p = tpar.VehicleParams.from_vector(torch.tensor(_CR_VEC,
                                                    dtype=torch.float64))
    u = torch.tensor([0.63 * 9.81, 0.15], dtype=torch.float64)
    f = getattr(tst, name)(torch.tensor(x, dtype=torch.float64), u, p)
    np.testing.assert_allclose(f.numpy(), expected, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_torch_single_track_rollout(integrator):
    rng = np.random.default_rng(7)
    pj, pt = _params(rng)
    x, _ = _st_inputs(rng)
    controls = np.stack([rng.uniform(-9, 9, (B, 5)),
                         rng.uniform(-3, 3, (B, 5))], axis=-1)
    j = jst.rollout(jnp.asarray(x), jnp.asarray(controls), pj,
                    integrator=integrator)
    t = tst.rollout(torch.from_numpy(x), torch.from_numpy(controls), pt,
                    integrator=integrator)
    assert t.shape == (B, 5, 7)
    _close(t, j)


def test_torch_reference_abi_rollouts():
    """integrate_st, kinematic_onestep, integrate_frenet (with and without
    the training floor on 1 - ey*curv, rows on both sides of it) and
    frenet_onestep: the row layouts the training losses build."""
    rng = np.random.default_rng(8)
    vec = np.array(jpar.f1tenth_params(dtype=jnp.float64).to_vector())
    x, u = _st_inputs(rng)
    tail = np.concatenate([rng.uniform(-9, 9, (B, 5)),
                           rng.uniform(-3, 3, (B, 5))], axis=1)
    rows = np.concatenate([x, tail], axis=1)
    _close(tst.integrate_st(torch.from_numpy(rows), torch.from_numpy(vec)),
           jst.integrate_st(jnp.asarray(rows), jnp.asarray(vec)))
    xu = np.concatenate([x, u], axis=1)
    _close(tst.kinematic_onestep(torch.from_numpy(xu), torch.from_numpy(vec)),
           jst.kinematic_onestep(jnp.asarray(xu), jnp.asarray(vec)))

    xf, uf, curv = _fr_inputs(rng)
    xf[:4, 1], curv[:4] = [2.2, -2.2, 2.3, 2.1], [0.45, -0.45, 0.45, 0.45]
    frows = np.concatenate([xf, curv[:, None], tail], axis=1)
    for eps in (None, 0.05):
        t = tfr.integrate_frenet(torch.from_numpy(frows),
                                 torch.from_numpy(vec), eps_denom=eps)
        assert t.shape == (B, 5, 8)
        _close(t, jfr.integrate_frenet(jnp.asarray(frows), jnp.asarray(vec),
                                       eps_denom=eps))
    one = np.concatenate([xf[:, 1:], curv[:, None], np.zeros((B, 1)), uf],
                         axis=1)
    _close(tfr.frenet_onestep(torch.from_numpy(one), torch.from_numpy(vec)),
           jfr.frenet_onestep(jnp.asarray(one), jnp.asarray(vec)))


# ------------------------------------------------------------------ spirals

def _spiral_params(rng):
    return np.concatenate([rng.uniform(-0.2, 0.2, (B, 4)),
                           rng.uniform(3.0, 30.0, (B, 1))], axis=1)


@pytest.mark.parametrize("name", ["params_to_coefs", "integrate_path",
                                  "integrate_endpoint_gl", "sample_path"])
def test_torch_spiral(name):
    p = _spiral_params(np.random.default_rng(9))
    _close(getattr(tsp, name)(torch.from_numpy(p)),
           getattr(jsp, name)(jnp.asarray(p)))


def test_torch_spiral_pieces():
    rng = np.random.default_rng(10)
    p = _spiral_params(rng)
    coefs = np.asarray(jsp.params_to_coefs(jnp.asarray(p)))
    s = rng.uniform(0.0, 30.0, B)
    for t, j in zip(tsp.curvature_theta(torch.from_numpy(coefs),
                                        torch.from_numpy(s)),
                    jsp.curvature_theta(jnp.asarray(coefs), jnp.asarray(s))):
        _close(t, j)
    k0, dk, sf = p[:, 0], p[:, 1] * 0.1, p[:, 4]
    _close(tsp.clothoid_to_params(*map(torch.from_numpy, (k0, dk, sf))),
           jsp.clothoid_to_params(*map(jnp.asarray, (k0, dk, sf))))
    # other quadrature sizes, and the node cache returns the same tensors
    _close(tsp.integrate_endpoint_gl(torch.from_numpy(p), order=8,
                                     segments=2),
           jsp.integrate_endpoint_gl(jnp.asarray(p), order=8, segments=2))
    assert (tsp._gl_nodes(8, 2, torch.float64, torch.device("cpu"))[0]
            is tsp._gl_nodes(8, 2, torch.float64, torch.device("cpu"))[0])
    # the endpoint is differentiable (the clothoid loss goes through it)
    q = torch.from_numpy(p).requires_grad_(True)
    tsp.integrate_endpoint_gl(q).sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0


# ------------------- the solve_ivp trajectory oracles, on the port's rk4_step

_SCENARIOS = {
    # name: (initial [x, y, delta, v, psi, psidot, beta], control [accl, sv])
    "braking": ([0.0, 0.0, 0.0, 20.0, 0.0, 0.0, 0.0], [-0.7 * 9.81, 0.0]),
    "acceleration": ([0.0, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0],
                     [0.63 * 9.81, 0.0]),
    "cornering": ([0.0, 0.0, 0.05, 15.0, 0.0, 0.0, 0.0], [0.0, 0.05]),
}


def _cr_params(dt):
    vec = list(_CR_VEC)
    vec[8] = dt
    return tpar.VehicleParams.from_vector(torch.tensor(vec,
                                                       dtype=torch.float64))


def _torch_rollout_rk4(x0, u, n_steps, dt):
    p = _cr_params(dt)
    x = torch.tensor(x0, dtype=torch.float64)
    u = torch.tensor(u, dtype=torch.float64)
    xs = [x]
    for _ in range(n_steps):
        x = tst.rk4_step(tst.st_deriv_cr, x, u, p)
        xs.append(x)
    return torch.stack(xs).numpy()


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_torch_trajectory_matches_ivp_oracle(name):
    """The port's fixed-step RK4 over ``st_deriv_cr`` tracks scipy's
    adaptive solve_ivp of the same derivative over a 1 s scenario, at the
    tolerances tests/test_dynamics_oracle.py holds the JAX package to."""
    from scipy.integrate import solve_ivp

    x0, u = _SCENARIOS[name]
    dt, t_final = 1e-3, 1.0
    traj = _torch_rollout_rk4(x0, u, int(t_final / dt), dt)
    p = _cr_params(dt)
    ut = torch.tensor(u, dtype=torch.float64)
    sol = solve_ivp(
        lambda t, x: tst.st_deriv_cr(torch.as_tensor(x), ut, p).numpy(),
        (0.0, t_final), np.asarray(x0, np.float64), rtol=1e-9, atol=1e-11,
        dense_output=True)
    assert sol.success
    ref = sol.sol(np.arange(len(traj)) * dt).T
    err = np.abs(traj - ref).max(axis=0)
    # pose and speed track the oracle tightly; psi_dot and beta tolerate
    # the right-hand side's jump at the |v| = 0.5 model switch
    assert err[[0, 1, 2, 3, 4]].max() < 1e-5, f"{name}: pose err {err}"
    assert err[[5, 6]].max() < 2e-3, f"{name}: psidot/beta err {err}"


def test_torch_braking_acceleration_and_stationary_invariants():
    x0, u = _SCENARIOS["braking"]
    traj = _torch_rollout_rk4(x0, u, 1000, 1e-3)
    v = traj[:, 3]
    assert (np.diff(v) <= 1e-12).all()
    np.testing.assert_allclose(traj[:, 1], 0.0, atol=1e-9)
    np.testing.assert_allclose(v[-1], 20.0 - 0.7 * 9.81, rtol=1e-6)
    x0, u = _SCENARIOS["acceleration"]
    traj = _torch_rollout_rk4(x0, u, 2000, 1e-3)
    assert np.isfinite(traj).all()
    assert (np.diff(traj[:, 3]) > 0).all() and traj[-1, 1] > 0.01
    f = tst.st_deriv_cr(torch.zeros(7, dtype=torch.float64),
                        torch.zeros(2, dtype=torch.float64), _cr_params(1e-2))
    np.testing.assert_array_equal(f.numpy(), 0.0)
