"""PyTorch port of the grip observer (``planning/grip.py``), the stateful
rollout and the grip-adaptive bank planner vs the JAX package.

- The four cases of ``tests/test_grip.py`` run through both packages: the
  estimate converges to mu*cs/(mu0*cs0) in the closed loop (both within
  that test's 8% of the truth, and the two estimates within 1e-5 of each
  other: the loop runs in f64, but the raceline is f32 in both packages and
  its geometry differs in the f32 last place, which 400 steps of feedback
  grow); it freezes at g0 without excitation (exactly, in both); the
  planner's policy step has the right shapes; and the product confound's
  two exact equalities hold bit for bit in the port's dynamics too.
- ``grip_update`` / ``grip_record`` and the planner's policy step on seeded
  observation sequences in f64: 1e-12 for the observer, 1e-9 for actions
  (three committed ``bank6_pr_mu*`` arms; their heads sum |w| ~ 1.3e5 per
  output, so an f64 forward rounds at ~1e-11).
- The bank planner in closed loop through ``rollout_stateful`` (three arms,
  8 lanes, 40 steps at 7.5 m/s so the observer's gate opens) in f64:
  actions per step to 1e-5 (the f32 raceline, as above), the arm of every
  lane and step equal, final g to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics import VehicleParams as JParams
from irbfn_tpu.dynamics import f1tenth_params as jf1tenth
from irbfn_tpu.dynamics.single_track import st_deriv as jst_deriv
from irbfn_tpu.planning import GripAdaptiveFrenetPlanner as JGripPlanner
from irbfn_tpu.planning import grip as jgrip
from irbfn_tpu.sim import TrackEnv as JEnv
from irbfn_tpu.sim import oval_track as joval
from irbfn_tpu.train import input_bounds_from_config, load_model
from irbfn_tpu_torch.dynamics import VehicleParams, f1tenth_params
from irbfn_tpu_torch.dynamics.single_track import st_deriv
from irbfn_tpu_torch.models import from_config
from irbfn_tpu_torch.planning import GripAdaptiveFrenetPlanner
from irbfn_tpu_torch.planning import grip as tgrip
from irbfn_tpu_torch.sim import TrackEnv, oval_track
from irbfn_tpu_torch.sim.env import Observation
from irbfn_tpu_torch.train import params_from_jax

torch.set_num_threads(1)
ARMS = (0.5, 0.8, 1.0)
SPEED_SCALE = 2.5  # the oval's 3 m/s raceline at 7.5 m/s: the gate opens


def _params(mus, css, np_dt):
    """Per-lane vehicles of both packages, in ``np_dt``."""
    base = np.asarray(jf1tenth().to_vector(), np.float64)
    B = len(mus)
    fields = [np.full(B, v) for v in base]
    fields[0] = np.asarray(mus, np.float64)
    fields[5] = fields[6] = np.asarray(css, np.float64)
    fields[8] = np.full(B, 0.01)
    fields = [f.astype(np_dt) for f in fields]
    return (JParams(*[jnp.asarray(f) for f in fields]),
            VehicleParams(*[torch.from_numpy(f) for f in fields]))


def _envs(mus, css, speed, np_dt=np.float64, **kw):
    jp, tp = _params(mus, css, np_dt)
    jt = joval(30.0, 15.0, n_samples=512, speed=speed)
    tt = oval_track(30.0, 15.0, n_samples=512, speed=speed, device="cpu")
    return JEnv(jt, jp, **kw), TrackEnv(tt, tp, **kw)


def _nominal(np_dt):
    jdt = jnp.float64 if np_dt == np.float64 else jnp.float32
    tdt = torch.float64 if np_dt == np.float64 else torch.float32
    jp = jf1tenth().astype(jdt)._replace(
        mu=jnp.asarray(1.0, jdt), C_Sf=jnp.asarray(5.0, jdt),
        C_Sr=jnp.asarray(5.0, jdt))
    # the f32 constants cast up, as the JAX planner's astype does
    tp = f1tenth_params(device="cpu").to("cpu", tdt)
    return jp, tp


@pytest.mark.parametrize("case", ["converges", "freezes"])
def test_torch_grip_estimate_matches_jax(case):
    """tests/test_grip.py's two observer loops, through both packages in
    f64 with the same tracking policy."""
    cfg = jgrip.GripConfig()
    tcfg = tgrip.GripConfig()
    if case == "converges":
        mus, css, speed, n_steps = [1.0, 0.7, 1.0, 0.5], [5, 5, 2.5, 5], 3.8, 400
        jenv, tenv = _envs(mus, css, speed, half_width=3.0)
    else:
        mus, css, speed, n_steps = [0.5], [5.0], 4.5, 100
        jp, tp = _params(mus, css, np.float64)
        jenv = JEnv(joval(400.0, 200.0, n_samples=512, speed=speed), jp)
        tenv = TrackEnv(oval_track(400.0, 200.0, n_samples=512, speed=speed,
                                   device="cpu"), tp)
    B = len(mus)
    jnom, tnom = _nominal(np.float64)

    def jpolicy(gs, obs):
        gs = jgrip.grip_update(gs, obs, cfg, 0.1)
        if case == "converges":
            sv = jnp.clip(-1.0 * obs.ey - 1.5 * obs.epsi - 0.8 * obs.delta,
                          -3.2, 3.2)
        else:
            sv = jnp.zeros_like(obs.ey)
        a = jnp.clip(2.0 * (speed - obs.linear_vel_x), -9.51, 9.51)
        action = jnp.stack([a, sv], axis=-1)
        return action, jgrip.grip_record(gs, obs, action, jnom, cfg)

    def tpolicy(gs, obs):
        gs = tgrip.grip_update(gs, obs, tcfg, 0.1)
        if case == "converges":
            sv = torch.clamp(-1.0 * obs.ey - 1.5 * obs.epsi
                             - 0.8 * obs.delta, -3.2, 3.2)
        else:
            sv = torch.zeros_like(obs.ey)
        a = torch.clamp(2.0 * (speed - obs.linear_vel_x), -9.51, 9.51)
        action = torch.stack([a, sv], dim=-1)
        return action, tgrip.grip_record(gs, obs, action, tnom, tcfg)

    jf, jgs, _ = jenv.rollout_stateful(
        jenv.reset(s0=jnp.zeros(B), speed0=1.0, batch_shape=(B,)),
        jax.jit(jpolicy), jgrip.grip_init((B,), cfg, jnp.float64), n_steps)
    tf, tgs, traj = tenv.rollout_stateful(
        tenv.reset(s0=0.0, speed0=1.0, batch_shape=(B,)), tpolicy,
        tgrip.grip_init((B,), tcfg, torch.float64, "cpu"), n_steps)
    assert traj.done.shape == (n_steps, B) and traj.obs.ey.shape == (n_steps, B)
    np.testing.assert_array_equal(tf.done.numpy(), np.asarray(jf.done))
    g_t, g_j = tgs.g.numpy(), np.asarray(jgs.g)
    if case == "converges":
        assert not tf.done.any()
        g_true = np.array([m * c / 5.0 for m, c in zip(mus, css)])
        np.testing.assert_allclose(g_t, g_true, rtol=0.08)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-5)
    else:
        assert float(g_t[0]) == tcfg.g0 == float(g_j[0])


def _obs_sequence(rng, n_steps, B, dt):
    """Seeded observation sequences: poses near an oval, speeds across the
    gate, lateral states that excite the tire model."""
    seq = []
    for _ in range(n_steps):
        f = [rng.uniform(-10, 10, B), rng.uniform(-5, 5, B),
             rng.uniform(-np.pi, np.pi, B), rng.uniform(-0.3, 0.3, B),
             rng.uniform(2.5, 7.5, B), rng.uniform(-0.4, 0.4, B),
             rng.uniform(-2.0, 2.0, B), rng.uniform(-0.15, 0.15, B),
             rng.uniform(0.0, 60.0, B), rng.uniform(-1.0, 1.0, B),
             rng.uniform(-0.6, 0.6, B)]
        seq.append([a.astype(dt) for a in f])
    return seq


def test_torch_grip_update_and_record_f64():
    from irbfn_tpu.sim.env import Observation as JObs

    rng = np.random.default_rng(0)
    B = 64
    cfg, tcfg = jgrip.GripConfig(), tgrip.GripConfig()
    jnom, tnom = _nominal(np.float64)
    jgs = jgrip.grip_init((B,), cfg, jnp.float64)
    tgs = tgrip.grip_init((B,), tcfg, torch.float64, "cpu")
    n_gated = 0
    for fields in _obs_sequence(rng, 6, B, np.float64):
        jo = JObs(*[jnp.asarray(f) for f in fields])
        to = Observation(*[torch.from_numpy(f) for f in fields])
        g_before = tgs.g.clone()
        jgs = jgrip.grip_update(jgs, jo, cfg, 0.1)
        tgs = tgrip.grip_update(tgs, to, tcfg, 0.1)
        n_gated += int((tgs.g != g_before).sum())
        act = rng.uniform(-3.0, 3.0, (B, 2))
        jgs = jgrip.grip_record(jgs, jo, jnp.asarray(act), jnom, cfg)
        tgs = tgrip.grip_record(tgs, to, torch.from_numpy(act), tnom, tcfg)
        for a, b in zip(tgs, jgs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
    assert n_gated > B  # the gate opened on many lanes and steps


def test_torch_product_confound_in_sim_dynamics():
    """tests/test_grip.py's confound: same-product (mu, cs) pairs give
    bit-equal single-track derivatives in the port too."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(-1, 1, (64, 7)) * np.array([5, 5, 0.3, 6, 3, 2.5, 0.3])
         + np.array([0, 0, 0, 4, 0, 0, 0]))
    u = rng.uniform(-1, 1, (64, 2)) * 3.0
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)

    def dmax(p1, p2):
        return float((st_deriv(tx, tu, f1tenth_params(mu=p1[0], cs=p1[1],
                                                      device="cpu"))
                      - st_deriv(tx, tu, f1tenth_params(
                          mu=p2[0], cs=p2[1], device="cpu"))).abs().max())

    assert dmax((0.5, 10.0), (1.0, 5.0)) == 0.0
    assert dmax((0.8, 2.5), (0.4, 5.0)) == 0.0
    assert dmax((0.4, 5.0), (1.0, 2.0)) < 5e-3
    assert dmax((1.0, 5.0), (0.5, 5.0)) > 1.0
    for mu, cs in ((0.5, 10.0), (0.4, 5.0)):
        np.testing.assert_allclose(
            st_deriv(tx, tu, f1tenth_params(mu=mu, cs=cs,
                                             device="cpu")).numpy(),
            np.asarray(jst_deriv(jnp.asarray(x), jnp.asarray(u),
                                 jf1tenth(mu=mu, cs=cs))),
            rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def arms():
    """Three committed bank arms: the JAX model and f64 variables, and the
    port's f64 nets."""
    jvars, nets, model, conf0 = [], [], None, None
    for mu in ARMS:
        m, v, conf = load_model(f"configs/bank6_pr_mu{mu:.2f}.yaml",
                                f"ckpts/bank6_pr_mu{mu:.2f}")
        v = jax.tree.map(np.asarray, {"params": v["params"]})
        net = from_config(conf, dtype=torch.float64, device="cpu")
        net.load_state_dict(params_from_jax(v, conf))
        nets.append(net.eval())
        jvars.append(jax.tree.map(lambda a: a.astype(np.float64), v))
        model, conf0 = model or m, conf0 or conf
    return model, jvars, nets, input_bounds_from_config(conf0)


def _planners(arms, track_j, track_t, **kw):
    model, jvars, nets, bounds = arms
    jp = JGripPlanner(model, jvars, ARMS, track_j, input_bounds=bounds,
                      dtype=jnp.float64, **kw)
    tp = GripAdaptiveFrenetPlanner(nets[0], nets, ARMS, track_t,
                                   input_bounds=bounds, dtype=torch.float64,
                                   **kw)
    return jp, tp


def test_torch_grip_planner_policy_steps_f64(arms):
    from irbfn_tpu.sim.env import Observation as JObs

    jt = joval(30.0, 15.0, n_samples=256, speed=4.0)
    tt = oval_track(30.0, 15.0, n_samples=256, speed=4.0, device="cpu")
    jp, tp = _planners(arms, jt, tt, pace_lo=0.2)
    B = 48
    jgs, tgs = jp.init_state((B,)), tp.init_state((B,))
    assert tgs.g.shape == (B,) and tgs.g.dtype == torch.float64
    jpol, tpol = jp.policy(), tp.policy()
    rng = np.random.default_rng(5)
    for fields in _obs_sequence(rng, 5, B, np.float64):
        ja, jgs = jpol(jgs, JObs(*[jnp.asarray(f) for f in fields]))
        ta, tgs = tpol(tgs, Observation(*[torch.from_numpy(f)
                                          for f in fields]))
        assert ta.shape == (B, 2) and torch.isfinite(ta).all()
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9,
                                   atol=1e-9)
        for a, b in zip(tgs, jgs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
    assert len(np.unique(tgs.g.numpy())) > 3  # lanes' estimates spread


def test_torch_grip_planner_closed_loop_matches_jax(arms):
    """Three arms in closed loop through rollout_stateful, f64."""
    mus = np.repeat([0.4, 0.7, 0.9, 1.1], 2)
    css = np.tile([3.0, 6.0], 4)
    jenv, tenv = _envs(mus, css, 3.0, half_width=2.0)
    rl_j, rl_t = jenv.track.raceline, tenv.track.raceline
    jenv.track = jenv.track._replace(raceline=rl_j._replace(
        vxs=rl_j.vxs * SPEED_SCALE))
    tenv.track = tenv.track._replace(raceline=rl_t._replace(
        vxs=rl_t.vxs * SPEED_SCALE))
    jp, tp = _planners(arms, jenv.track, tenv.track, pace_lo=0.2)
    B, n = len(mus), 40
    acts = {"j": [], "t": [], "gj": [], "gt": []}
    jpol, tpol = jp.policy(), tp.policy()

    def jlog(gs, obs):
        a, gs = jpol(gs, obs)
        acts["j"].append(np.asarray(a))
        acts["gj"].append(np.asarray(gs.g))
        return a, gs

    def tlog(gs, obs):
        a, gs = tpol(gs, obs)
        acts["t"].append(a.numpy().copy())
        acts["gt"].append(gs.g.numpy().copy())
        return a, gs

    # a Python loop on the JAX side too, to log every step's action
    js = jenv.reset(s0=jnp.zeros(B), speed0=1.0, batch_shape=(B,))
    jgs = jp.init_state((B,))
    for _ in range(n):
        obs = jenv.observe(js)
        a, jgs = jlog(jgs, obs)
        js = jenv.step(js, a)
    tf, tgs, _ = tenv.rollout_stateful(
        tenv.reset(s0=0.0, speed0=1.0, batch_shape=(B,)), tlog,
        tp.init_state((B,)), n)
    np.testing.assert_allclose(np.stack(acts["t"]), np.stack(acts["j"]),
                               rtol=0, atol=1e-5)
    mu_arr = np.asarray(ARMS)

    def arm_of(g):
        return np.argmin(np.abs(mu_arr - np.clip(g, mu_arr[0], mu_arr[-1])
                                [..., None]), -1)

    arm_t, arm_j = arm_of(np.stack(acts["gt"])), arm_of(np.stack(acts["gj"]))
    np.testing.assert_array_equal(arm_t, arm_j)
    assert len(np.unique(arm_t)) >= 2  # the loop drives more than one arm
    np.testing.assert_allclose(tgs.g.numpy(), np.asarray(jgs.g), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tf.done.numpy(), np.asarray(js.done))


def test_torch_stack_net_bank_matches_jax(arms):
    """Every arm on one batch, then a gather by arm: each row equals its
    arm's own forward, and the bank equals the JAX package's vmapped one
    (the first arm's constants for every arm, as there) in f64."""
    from irbfn_tpu.planning import stack_net_bank as jstack
    from irbfn_tpu_torch.planning import stack_net_bank

    model, jvars, nets, bounds = arms
    rng = np.random.default_rng(7)
    lo = np.where(np.isfinite(bounds[:, 0]), bounds[:, 0], -1.0)
    hi = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1.0)
    x = rng.uniform(lo, hi, (4, 6, 8))
    japply, jstacked = jstack(model, jvars)
    want = np.asarray(japply(jstacked, jnp.asarray(x.reshape(-1, 8))))
    apply_fn, bank = stack_net_bank(nets[0], nets)
    got = apply_fn(bank, torch.from_numpy(x))
    assert got.shape == (3, 4, 6, 10)
    np.testing.assert_allclose(got.numpy().reshape(3, -1, 10), want,
                               rtol=1e-9, atol=1e-9)
    arm = torch.from_numpy(rng.integers(0, 3, (4, 6)))
    picked = torch.gather(got, 0, arm[None, ..., None].expand(1, 4, 6, 10))[0]
    for a in range(3):
        rows = (arm == a).numpy()
        np.testing.assert_array_equal(picked.numpy()[rows],
                                      got[a].numpy()[rows])
    # the first arm is its own net; the others carry its constants
    with torch.no_grad():
        own = nets[0](torch.from_numpy(x.reshape(-1, 8)))
    np.testing.assert_array_equal(got[0].numpy().reshape(-1, 10), own.numpy())
    assert torch.equal(bank[2].centers, nets[2].centers)
    assert torch.equal(bank[2].input_scale, nets[0].input_scale)


def test_torch_adaptive_planner_matches_jax_weights():
    """AdaptiveIRBFNPlanner: the pulled arm's planner plans, and rewards
    move the EXP3 weights as in the JAX package given the same arms."""
    from irbfn_tpu.planning import AdaptiveIRBFNPlanner as JAdaptive
    from irbfn_tpu_torch.planning import AdaptiveIRBFNPlanner

    class Fixed:
        def __init__(self, a):
            self.a = a

        def plan(self, obs):
            return (self.a, -self.a)

    tp = AdaptiveIRBFNPlanner([Fixed(0.0), Fixed(1.0), Fixed(2.0)],
                              gamma=0.2, seed=0)
    jp = JAdaptive([Fixed(0.0), Fixed(1.0), Fixed(2.0)], gamma=0.2, seed=0)
    for r in (0.3, 1.0, -0.5, 2.0, 0.7):
        arm = tp.select()
        assert tp.plan({}) == (float(arm), -float(arm))
        jp.bandit.state = jp.bandit.state._replace(
            last_probs=jnp.asarray(tp.bandit.state.last_probs.numpy()))
        jp.current_arm = arm
        tp.reward(r)
        jp.reward(r)
        np.testing.assert_allclose(tp.bandit.weights,
                                   np.asarray(jp.bandit.state.weights),
                                   rtol=1e-6)
