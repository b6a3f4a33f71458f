"""PyTorch port of the track, Frenet frame and TrackEnv vs the JAX package.

Tracks are built on the host in f64 and cast to f32 by both packages, so
their arrays must be bit-equal. Conversions and env steps run in f64 on
numpy-drawn poses, states and per-lane parameters and agree to ~1e-12, or
to the f32 last place where a value derives from the f32 raceline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics import VehicleParams as JParams
from irbfn_tpu.dynamics import f1tenth_params as jf1tenth
from irbfn_tpu.sim import TrackEnv as JEnv
from irbfn_tpu.sim import safety as jsafety
from irbfn_tpu.sim import deviation_metrics as jdev
from irbfn_tpu.sim import track as jtrack
from irbfn_tpu.sim.env import Observation as JObs
from irbfn_tpu.sim.env import StepRecord as JRecord
from irbfn_tpu.solvers.clothoid import wrap_angle as jwrap
from irbfn_tpu_torch.dynamics import VehicleParams, f1tenth_params
from irbfn_tpu_torch.sim import TrackEnv, deviation_metrics
from irbfn_tpu_torch.sim import safety as tsafety
from irbfn_tpu_torch.sim import track as ttrack
from irbfn_tpu_torch.sim.env import Observation, StepRecord

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)
# the raceline is f32 in both packages, and XLA contracts f32 multiply-adds
# (segment lengths, tangents) into FMAs where PyTorch rounds twice: values
# derived from raceline geometry differ in the f32 last place
TOL_GEOM = dict(rtol=1e-6, atol=1e-6)
CSV = "data/Oschersleben_raceline_feasible.csv"


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


@pytest.fixture(scope="module")
def tracks():
    return (jtrack.oval_track(30.0, 15.0, n_samples=512, speed=3.0),
            ttrack.oval_track(30.0, 15.0, n_samples=512, speed=3.0,
                              device="cpu"))


@pytest.mark.parametrize("which", ["oval512", "oval1024", "csv"])
def test_torch_track_arrays_bit_equal(which):
    if which == "csv":
        kw = dict(speed_col=5, delimiter=";", skip_header=0)
        j = jtrack.from_csv(CSV, 1, 2, **kw)
        t = ttrack.from_csv(CSV, 1, 2, device="cpu", **kw)
    else:
        n = int(which[4:])
        j = jtrack.oval_track(30.0, 15.0, n_samples=n, speed=3.0)
        t = ttrack.oval_track(30.0, 15.0, n_samples=n, speed=3.0,
                               device="cpu")
    for a, b in zip(t.raceline, j.raceline):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_frenet_conversions_f64(tracks):
    jt, tt = tracks
    rng = np.random.default_rng(0)
    L = float(tt.raceline.length)
    s = rng.uniform(-L, 2 * L, 200)  # wraps both ways
    ey = rng.uniform(-2.0, 2.0, 200)
    epsi = rng.uniform(-3.0, 3.0, 200)
    xj = jt.frenet_to_cartesian(jnp.asarray(s), jnp.asarray(ey),
                                jnp.asarray(epsi))
    xt = tt.frenet_to_cartesian(*map(torch.from_numpy, (s, ey, epsi)))
    for a, b in zip(xt, xj):
        _close(a, b, **TOL_GEOM)
    theta = rng.uniform(-10.0, 10.0, 200)  # accumulated over laps
    fj = jt.cartesian_to_frenet(xj[0], xj[1], jnp.asarray(theta))
    ft = tt.cartesian_to_frenet(xt[0], xt[1], torch.from_numpy(theta))
    for a, b in zip(ft, fj):
        _close(a, b, **TOL_GEOM)
    _close(ttrack.wrap_angle(torch.from_numpy(theta)),
           jwrap(jnp.asarray(theta)))


def test_torch_interp_and_goal_speed(tracks):
    jt, tt = tracks
    rng = np.random.default_rng(1)
    L = float(tt.raceline.length)
    s = np.concatenate([rng.uniform(-L, 2 * L, 100), [0.0, L, L - 1e-6]])
    vx = rng.uniform(0.0, 8.0, s.size)
    rj, rt = jt.raceline, tt.raceline
    _close(ttrack.interp_wrapped(rt.ss, rt.ks, torch.from_numpy(s),
                                 rt.length),
           jtrack.interp_wrapped(rj.ss, rj.ks, jnp.asarray(s), rj.length))
    _close(ttrack.horizon_goal_speed(rt, torch.from_numpy(s),
                                     torch.from_numpy(vx), 0.5),
           jtrack.horizon_goal_speed(rj, jnp.asarray(s), jnp.asarray(vx),
                                     0.5))
    _close(tt.curvature_at(torch.from_numpy(s)), jt.curvature_at(
        jnp.asarray(s)))


def _lane_params(mu, cs):
    """Per-lane f64 params for both packages, as the eval sweep builds."""
    B = mu.size
    base = np.asarray(jf1tenth(dtype=jnp.float64).to_vector())
    vec = np.tile(base, (B, 1))
    vec[:, 0], vec[:, 5], vec[:, 6], vec[:, 8] = mu, cs, cs, 0.01
    return (JParams.from_vector(jnp.asarray(vec)),
            VehicleParams.from_vector(torch.from_numpy(vec)))


def _jax_reset(env, B, noise, scale=0.01, s0=0.0):
    """JAX reset plus numpy-drawn pose noise (reset's own noise comes from a
    jax key): the same arithmetic as reset(noise=...) in the port."""
    sim = env.reset(s0=jnp.full((B,), s0), speed0=1.0, batch_shape=(B,))
    dn = scale * jnp.asarray(noise, sim.x.dtype)
    x = sim.x.at[:, 0].add(dn[:, 0]).at[:, 1].add(dn[:, 1])
    return sim._replace(x=x.at[:, 4].add(dn[:, 2]))


def test_torch_env_reset(tracks):
    jt, tt = tracks
    mu, cs = np.array([0.5, 0.8, 1.1]), np.array([1.0, 5.5, 10.0])
    pj, pt = _lane_params(mu, cs)
    noise = np.random.default_rng(2).standard_normal((3, 3))
    sj = _jax_reset(JEnv(jt, pj), 3, noise)
    st = TrackEnv(tt, pt).reset(s0=0.0, speed0=1.0, batch_shape=(3,),
                                noise=torch.from_numpy(noise),
                                noise_scale=0.01)
    for a, b in zip(st, sj):
        _close(a, b)
    assert st.laps.dtype == torch.int32 and st.done.dtype == torch.bool
    gen = TrackEnv(tt, pt).reset(batch_shape=(3,), noise_scale=0.01,
                                 noise=torch.Generator().manual_seed(0))
    assert gen.x.shape == (3, 7) and not torch.equal(gen.x[:, 0],
                                                     st.x[:, 0] * 0)


def test_torch_env_step_done_laps_and_corridor(tracks):
    """Ten control steps of per-lane (mu, cs) lanes: one starts just before
    the lap line, one leaves the corridor, one is already terminated (frozen
    in place)."""
    jt, tt = tracks
    rng = np.random.default_rng(3)
    B = 6
    L = float(tt.raceline.length)
    pj, pt = _lane_params(rng.uniform(0.5, 1.1, B), rng.uniform(1, 10, B))
    je, te = JEnv(jt, pj, half_width=0.5), TrackEnv(tt, pt, half_width=0.5)
    noise = rng.standard_normal((B, 3))
    sj = _jax_reset(je, B, noise, s0=L - 0.3)
    st = te.reset(s0=L - 0.3, speed0=1.0, batch_shape=(B,),
                  noise=torch.from_numpy(noise), noise_scale=0.01)
    done = np.array([False, False, True, False, False, False])
    sj = sj._replace(done=jnp.asarray(done))
    st = st._replace(done=torch.from_numpy(done))
    actions = np.stack([rng.uniform(-3, 9, B), rng.uniform(-1, 1, B)], -1)
    actions[1] = [9.0, 3.2]  # hard left: leaves the 0.5 m corridor
    for _ in range(10):
        sj = je.step(sj, jnp.asarray(actions))
        st = te.step(st, torch.from_numpy(actions))
    for a, b in zip(st, sj):
        _close(a, b)
    assert bool(st.done[1]) and bool(st.done[2])
    assert int(st.laps.max()) == 1  # the lap line was crossed


def test_torch_rollout_and_deviation_metrics(tracks):
    """A P-controller rollout of 40 steps, and deviation_metrics' masking
    of steps after termination."""
    jt, tt = tracks
    B = 4
    pj, pt = _lane_params(np.full(B, 1.0), np.full(B, 5.0))
    noise = np.random.default_rng(4).standard_normal((B, 3))
    je, te = JEnv(jt, pj, half_width=2.0), TrackEnv(tt, pt, half_width=2.0)

    def pol_j(o):
        return jnp.stack([2.0 * (3.0 - o.linear_vel_x),
                          -o.ey - 1.5 * o.epsi - 0.8 * o.delta], -1)

    def pol_t(o):
        return torch.stack([2.0 * (3.0 - o.linear_vel_x),
                            -o.ey - 1.5 * o.epsi - 0.8 * o.delta], -1)

    fj, trj = je.rollout(_jax_reset(je, B, noise), pol_j, 40)
    ft, trt = te.rollout(te.reset(speed0=1.0, batch_shape=(B,),
                                  noise=torch.from_numpy(noise),
                                  noise_scale=0.01), pol_t, 40)
    for a, b in zip(ft, fj):
        _close(a, b, **TOL_GEOM)
    for a, b in zip(trt.obs, trj.obs):
        _close(a, b, **TOL_GEOM)
    # masking: a done pattern shared by both packages' records
    done = np.zeros((40, B), bool)
    done[10:, 1] = True
    rec_j = JRecord(trj.obs, jnp.asarray(done), trj.laps)
    rec_t = StepRecord(trt.obs, torch.from_numpy(done), trt.laps)
    for a, b in zip(deviation_metrics(rec_t), jdev(rec_j)):
        _close(a, b, **TOL_GEOM)
    obs_j = JObs(*trj.obs[:11], None)
    for a, b in zip(deviation_metrics(Observation(*trt.obs)), jdev(obs_j)):
        _close(a, b, **TOL_GEOM)
    # the masking itself, on identical inputs: exact to rounding
    rec_t = StepRecord(Observation(*[torch.from_numpy(np.array(v))
                                     for v in trj.obs[:11]]),
                       torch.from_numpy(done), trt.laps)
    for a, b in zip(deviation_metrics(rec_t), jdev(rec_j)):
        _close(a, b)


def test_torch_env_not_ported_options_raise(tracks):
    _, tt = tracks
    for kw in ({"occ_map": object()}, {"scan_spec": object()},
               {"enable_ttc": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrackEnv(tt, f1tenth_params(device="cpu"), **kw)


def _pid_inputs(rng, B):
    """Speed/steer commands against current states that hit every branch:
    the steering deadband (|diff| <= 1e-4, both sides of it), speeding up
    and braking, forward (v > 0) and reverse (v <= 0, v == 0 exactly)."""
    steer_now = rng.uniform(-0.4, 0.4, B)
    dsteer = rng.uniform(-0.3, 0.3, B)
    dsteer[:B // 4] = rng.uniform(-9e-5, 9e-5, B // 4)  # inside the deadband
    dsteer[B // 4] = 0.0
    v_now = rng.uniform(-4.0, 7.0, B)
    v_now[B // 4:B // 4 + 3] = 0.0
    speed = v_now + rng.uniform(-3.0, 3.0, B)
    return speed, steer_now + dsteer, v_now, steer_now


def test_torch_pid_and_speed_action_f64():
    rng = np.random.default_rng(8)
    B = 64
    speed, steer, v_now, steer_now = _pid_inputs(rng, B)
    pj, pt = _lane_params(rng.uniform(0.5, 1.1, B), rng.uniform(1, 10, B))
    assert ((v_now <= 0) & (speed > v_now)).any()
    assert ((v_now > 0) & (speed < v_now)).any()
    for v_min in (None, -3.0):
        aj = jsafety.pid_lowlevel(*map(jnp.asarray, (speed, steer, v_now,
                                                     steer_now)), pj,
                                  v_min=v_min)
        at = tsafety.pid_lowlevel(*map(torch.from_numpy, (speed, steer, v_now,
                                                          steer_now)), pt,
                                  v_min=v_min)
        for a, b in zip(at, aj):
            _close(a, b)
    assert (at[1] == 0.0).sum() >= B // 4  # the deadband held
    state = np.zeros((B, 7))
    state[:, 2], state[:, 3] = steer_now, v_now
    action = np.stack([speed, steer], axis=-1)
    _close(tsafety.ACTION_MODES["speed"](torch.from_numpy(action),
                                        torch.from_numpy(state), pt),
           jsafety.speed_action(jnp.asarray(action), jnp.asarray(state), pj))


def test_torch_env_steps_in_speed_mode(tracks):
    """Ten control steps of [speed, steer] actions through the PID: the
    same states as the JAX env, in f64."""
    jt, tt = tracks
    rng = np.random.default_rng(9)
    B = 6
    pj, pt = _lane_params(rng.uniform(0.5, 1.1, B), rng.uniform(1, 10, B))
    je = JEnv(jt, pj, half_width=2.0, control_mode="speed")
    te = TrackEnv(tt, pt, half_width=2.0, control_mode="speed")
    noise = rng.standard_normal((B, 3))
    sj = _jax_reset(je, B, noise)
    st = te.reset(speed0=1.0, batch_shape=(B,), noise=torch.from_numpy(noise),
                  noise_scale=0.01)
    actions = np.stack([rng.uniform(0.5, 4.0, B), rng.uniform(-0.3, 0.3, B)],
                       -1)
    for _ in range(10):
        sj = je.step(sj, jnp.asarray(actions))
        st = te.step(st, torch.from_numpy(actions))
    for a, b in zip(st, sj):
        _close(a, b, **TOL_GEOM)
    assert not st.done.any()
