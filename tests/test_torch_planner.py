"""PyTorch port of IRBFNFrenetPlanner and the closed loop vs the JAX package.

The flagship ``frenet_wide_pr1`` net is loaded through orbax
(``irbfn_tpu.train.load_model``) and handed to the port with
``params_from_jax``. On the CPU the port's net runs its plain forward.

- ``plan_batch``: rows that are mirrored (ey < -0.05) and clamped into the
  trained grid; in f64 the packages agree to rounding, in f32 to the head's
  conditioning (sum |w| ~ 2e5 per output: 1e-3 abs).
- The 9-lane (mu x cs) closed loop of 300 control steps on the oval. In f64
  the per-step actions agree to 1e-5 (measured 2.6e-7): the raceline is f32
  in both packages and its geometry differs in the f32 last place (XLA
  contracts f32 multiply-adds into FMAs), and 300 steps of feedback grow
  that. In f32 the actions drift further apart (~3e-2 by the end), but
  every lane's laps and done flag are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics import VehicleParams as JParams
from irbfn_tpu.dynamics import f1tenth_params as jf1tenth
from irbfn_tpu.planning import IRBFNFrenetPlanner as JPlanner
from irbfn_tpu.sim import TrackEnv as JEnv
from irbfn_tpu.sim import oval_track as joval
from irbfn_tpu.train import input_bounds_from_config, load_model
from irbfn_tpu_torch.dynamics import VehicleParams
from irbfn_tpu_torch.models import from_config
from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
from irbfn_tpu_torch.sim import TrackEnv, deviation_metrics, oval_track
from irbfn_tpu_torch.train import params_from_jax

torch.set_num_threads(1)
DTYPES = {"f64": (np.float64, jnp.float64, torch.float64),
          "f32": (np.float32, jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def flagship():
    model, variables, config = load_model("configs/frenet_wide_pr1.yaml",
                                          "ckpts/frenet_wide_pr1")
    variables = jax.tree.map(np.asarray, {"params": variables["params"]})
    nets, jparams = {}, {}
    for name, (ndt, _, tdt) in DTYPES.items():
        net = from_config(config, dtype=tdt)
        net.load_state_dict(params_from_jax(variables, config))
        nets[name] = net
        # f64 runs get f64 weights on the JAX side too: f32 weights would
        # round exp(log_sigs) to f32 inside the flax forward, which the
        # head's conditioning turns into ~4e-5 at the outputs
        jparams[name] = jax.tree.map(lambda a: a.astype(ndt), variables)
    return model, jparams, input_bounds_from_config(config), nets


def _jax_precision(name):
    """f64 as the test session runs JAX; f32 at the JAX package's serving
    precision (x64 off), so its flax gate is f32 as in deployment."""
    return jax.enable_x64(name == "f64")


def _plan_inputs(rng, n, length):
    """[s, ey, epsi, delta, vx, vy, wz]: a third mirrored, and states up to
    15% past the trained grid's bounds (clamped)."""
    ey = np.where(np.arange(n) % 3 == 0, rng.uniform(-1.0, -0.05, n),
                  rng.uniform(-0.05, 1.0, n))
    return np.stack([rng.uniform(0, length, n), ey,
                     rng.uniform(-1.15, 1.15, n), rng.uniform(-0.35, 0.35, n),
                     rng.uniform(0.5, 9.0, n), rng.uniform(-1.15, 1.15, n),
                     rng.uniform(-3.0, 3.0, n)], axis=-1)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_torch_plan_batch_matches_jax(flagship, name):
    model, variables, bounds, nets = flagship
    ndt, jdt, tdt = DTYPES[name]
    tt = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    rng = np.random.default_rng(0)
    x = _plan_inputs(rng, 240, float(tt.raceline.length)).astype(ndt)
    # mirrored rows, and rows the clamp moves, are both present
    assert (x[:, 1] < -0.05).sum() >= 60
    assert ((np.abs(x[:, 2]) > 1.0) | (x[:, 4] > 8.0)).sum() >= 20
    with _jax_precision(name):
        jp = JPlanner(model, variables[name],
                      joval(30.0, 15.0, n_samples=512, speed=3.0),
                      dtype=jdt, use_pallas=False, input_bounds=bounds)
        rj = jp.plan_batch(*x.T)
        rj = jax.tree.map(np.asarray, rj)
    rt = IRBFNFrenetPlanner(nets[name], tt, dtype=tdt,
                            input_bounds=bounds).plan_batch(
        *torch.from_numpy(x).T)
    tol = (dict(rtol=1e-9, atol=1e-9) if name == "f64"
           else dict(rtol=0.0, atol=1e-3))
    for field in rj._fields:
        got = getattr(rt, field)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.numpy(), getattr(rj, field),
                                   err_msg=field, **tol)
    # the obs-dict API of one car: a pose on the track, projected first
    xs, ys, th = (float(v) for v in tt.frenet_to_cartesian(
        torch.tensor(10.0, dtype=tdt), torch.tensor(-0.3, dtype=tdt),
        torch.tensor(0.1, dtype=tdt)))
    obs = dict(pose_x=xs, pose_y=ys, pose_theta=th, delta=0.05,
               linear_vel_x=3.0, linear_vel_y=-0.1, ang_vel_z=0.2)
    with _jax_precision(name):
        pj = jp.plan(obs)
    pt = IRBFNFrenetPlanner(nets[name], tt, dtype=tdt,
                            input_bounds=bounds).plan(obs)
    # the projection onto the f32 raceline differs in the f32 last place
    # (XLA's FMAs), which the head's conditioning lifts to ~2e-6
    np.testing.assert_allclose(pt, pj, rtol=0.0,
                               atol=1e-5 if name == "f64" else 1e-3)


def _lanes(ndt):
    mu, cs = np.meshgrid([0.5, 0.8, 1.1], [1.0, 5.5, 10.0], indexing="ij")
    vec = np.tile(np.asarray(jf1tenth(dtype=jnp.float64).to_vector()), (9, 1))
    vec[:, 0], vec[:, 5], vec[:, 6], vec[:, 8] = mu.ravel(), cs.ravel(), \
        cs.ravel(), 0.01
    return vec.astype(ndt)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_torch_closed_loop_matches_jax(flagship, name):
    model, variables, bounds, nets = flagship
    ndt, jdt, tdt = DTYPES[name]
    B, N = 9, 300
    vec = _lanes(ndt)
    noise = np.random.default_rng(1).standard_normal((B, 3))
    with _jax_precision(name):
        jt = joval(30.0, 15.0, n_samples=512, speed=3.0)
        je = JEnv(jt, JParams.from_vector(jnp.asarray(vec)), half_width=2.0)
        sim = je.reset(s0=jnp.zeros(B, jdt), speed0=1.0, batch_shape=(B,))
        dn = 0.01 * jnp.asarray(noise, jdt)
        sim = sim._replace(x=sim.x.at[:, 0].add(dn[:, 0]).at[:, 1].add(
            dn[:, 1]).at[:, 4].add(dn[:, 2]))
        jp = JPlanner(model, variables[name], jt, dtype=jdt, use_pallas=False,
                      input_bounds=bounds)

        def jpolicy(o):
            r = jp.plan_batch(o.s, o.ey, o.epsi, o.delta, o.linear_vel_x,
                              o.linear_vel_y, o.ang_vel_z)
            return jnp.stack([r.accel, r.steer_vel], axis=-1)

        fj, trj = je.rollout(sim, jpolicy, N)
        # the actions JAX took: its policy on its own observations
        oj = trj.obs
        aj = jpolicy(jax.tree.map(lambda v: v.reshape(-1), oj))
        aj, fj = np.asarray(aj).reshape(N, B, 2), jax.tree.map(np.asarray,
                                                                 fj)

    tt = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    te = TrackEnv(tt, VehicleParams.from_vector(torch.from_numpy(vec)),
                  half_width=2.0)
    tp = IRBFNFrenetPlanner(nets[name], tt, dtype=tdt, input_bounds=bounds)
    actions = []

    def tpolicy(o):
        r = tp.plan_batch(o.s, o.ey, o.epsi, o.delta, o.linear_vel_x,
                          o.linear_vel_y, o.ang_vel_z)
        actions.append(torch.stack([r.accel, r.steer_vel], dim=-1))
        return actions[-1]

    ft, trt = te.rollout(te.reset(speed0=1.0, batch_shape=(B,),
                                  noise=torch.from_numpy(noise),
                                  noise_scale=0.01), tpolicy, N)
    np.testing.assert_array_equal(ft.laps.numpy(), fj.laps)
    np.testing.assert_array_equal(ft.done.numpy(), fj.done)
    assert (ft.laps.numpy() == 1).all() and not ft.done.any()
    if name == "f64":
        np.testing.assert_allclose(torch.stack(actions).numpy(), aj,
                                   rtol=0.0, atol=1e-5)
        ey_t = deviation_metrics(trt)[0].numpy()
        ey_j = np.abs(np.asarray(oj.ey)).mean(0)
        np.testing.assert_allclose(ey_t, ey_j, rtol=0.0, atol=1e-7)
