"""PyTorch port of the explicit (lookup-table) planners and the EXP3 bandit
vs the JAX package.

Random lattices with invalid (-999) rows and a singleton axis go through
every function of ``planning/explicit.py`` in both packages: values to
``TOL`` in f64, row indices and validity flags exactly. The JAX package's
own cases (``tests/test_planning.py``) are repeated on the port. The bandit's
state functions are held against JAX; its arm draws come from another
generator, so they are held against the sampling distribution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.planning import bandits as jb
from irbfn_tpu.planning import explicit as je
from irbfn_tpu.sim import oval_track as joval
from irbfn_tpu_torch.planning import bandits as tb
from irbfn_tpu_torch.planning import explicit as te
from irbfn_tpu_torch.sim import oval_track

torch.set_num_threads(1)
TOL = 1e-12


def lattice(nums, seed, n_out=4, p_invalid=0.2, dtype=np.float64):
    """A random regular lattice (inputs, outputs (N, T, 2)) with invalid
    rows; ``nums`` may hold 1 (a singleton axis)."""
    rng = np.random.default_rng(seed)
    axes = [np.sort(rng.uniform(-2, 2, 1)) if n == 1 else
            np.linspace(*sorted(rng.uniform(-2, 2, 2) + [0.0, 0.5]), n)
            for n in nums]
    mesh = np.meshgrid(*axes, indexing="ij")
    inputs = np.stack([m.reshape(-1) for m in mesh], -1).astype(dtype)
    outputs = rng.normal(size=(len(inputs), n_out // 2, 2)).astype(dtype)
    outputs[rng.random(len(inputs)) < p_invalid] = -999.0
    return inputs, outputs


def queries(inputs, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = inputs.min(0), inputs.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, inputs.shape[1]))
    q[: n // 4] = inputs[rng.integers(0, len(inputs), n // 4)]  # on the grid
    return q


def both_tables(inputs, outputs, valid=None):
    return (je.grid_table_from_arrays(inputs, outputs, valid),
            te.grid_table_from_arrays(inputs, outputs, valid, device="cpu"))


CASES = {"3d": (5, 4, 7), "singleton": (4, 1, 5), "4d": (3, 3, 2, 4),
         "two_singletons": (1, 6, 1)}


@pytest.mark.parametrize("case", CASES)
def test_grid_table_from_arrays_matches_jax(case):
    inputs, outputs = lattice(CASES[case], 0)
    jt, tt = both_tables(inputs, outputs)
    assert tt.nums == jt.nums
    np.testing.assert_array_equal(tt.lows.numpy(), np.asarray(jt.lows))
    np.testing.assert_array_equal(tt.steps.numpy(), np.asarray(jt.steps))
    np.testing.assert_array_equal(tt.outputs.numpy(), np.asarray(jt.outputs))
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    assert 0 < tt.valid.float().mean() < 1
    # an explicit valid mask wins over the -999 scan
    mask = np.arange(len(inputs)) % 2 == 0
    jt2, tt2 = both_tables(inputs, outputs, mask)
    np.testing.assert_array_equal(tt2.valid.numpy(), np.asarray(jt2.valid))


@pytest.mark.parametrize("case", CASES)
def test_grid_lookup_matches_jax(case):
    inputs, outputs = lattice(CASES[case], 1)
    jt, tt = both_tables(inputs, outputs)
    q = queries(inputs, 64, 2)
    jo, jv = je.grid_lookup(jt, jnp.asarray(q))
    to, tv = te.grid_lookup(tt, torch.as_tensor(q))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the same rows, so the same values bit for bit
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("case", CASES)
def test_grid_lookup_linear_matches_jax(case):
    inputs, outputs = lattice(CASES[case], 3)
    jt, tt = both_tables(inputs, outputs)
    q = queries(inputs, 64, 4)
    jo, jv = je.grid_lookup_linear(jt, jnp.asarray(q))
    to, tv = te.grid_lookup_linear(tt, torch.as_tensor(q))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    assert np.all(to.numpy()[tv.numpy()] > -100)  # no -999 leaks


def test_stack_grid_tables_matches_jax():
    tabs = [lattice((4, 3, 5), s) for s in (5, 6, 7)]
    inputs = tabs[0][0]
    pairs = [both_tables(inputs, o) for _, o in tabs]
    js = je.stack_grid_tables([p[0] for p in pairs])
    ts = te.stack_grid_tables([p[1] for p in pairs])
    assert ts.nums == js.nums == (3, 4, 3, 5)
    q = queries(inputs, 48, 8)
    arm = np.random.default_rng(9).integers(0, 3, (48, 1)).astype(np.float64)
    qa = np.concatenate([arm, q], 1)
    for jfn, tfn in ((je.grid_lookup, te.grid_lookup),
                     (je.grid_lookup_linear, te.grid_lookup_linear)):
        jo, jv = jfn(js, jnp.asarray(qa))
        to, tv = tfn(ts, torch.as_tensor(qa))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
        # an integer arm id selects exactly that arm's table
        for a in range(3):
            sel = arm[:, 0] == a
            one, _ = tfn(pairs[a][1], torch.as_tensor(q[sel]))
            np.testing.assert_allclose(to.numpy()[sel], one.numpy(), rtol=0,
                                       atol=TOL)
    with pytest.raises(ValueError):
        te.stack_grid_tables([pairs[0][1], te.grid_table_from_arrays(
            *lattice((4, 3, 4), 1), device="cpu")])


def test_nn_table_and_lookup_match_jax():
    inputs, outputs = lattice((5, 4, 3), 10, dtype=np.float32)
    jt = je.nn_table_from_arrays(inputs, outputs)
    tt = te.nn_table_from_arrays(inputs, outputs, device="cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert len(tt.inputs) < len(inputs)  # the invalid rows are gone
    q = queries(inputs, 40, 11).astype(np.float32)
    jo, ji = je.nn_lookup(jt, jnp.asarray(q))
    to, ti = te.nn_lookup(tt, torch.as_tensor(q))
    # f32 distances: an index may differ only between two rows at the same
    # distance to f32 rounding
    d = ((q[:, None] * np.asarray(jt.scale) - np.asarray(jt.inputs)[None])
         ** 2).sum(-1)
    ji, ti = np.asarray(ji), ti.numpy()
    rows = np.arange(len(q))
    assert np.all(np.abs(d[rows, ji] - d[rows, ti]) <= 1e-5)
    assert (ji == ti).mean() >= 0.95
    same = ji == ti
    np.testing.assert_array_equal(to.numpy()[same], np.asarray(jo)[same])
    # a custom scale is kept
    tt2 = te.nn_table_from_arrays(inputs, outputs, scale=np.ones(3),
                                  device="cpu")
    np.testing.assert_array_equal(tt2.scale.numpy(), np.ones(3, np.float32))


# ------------------- the JAX package's own cases, repeated on the port

def _toy_table():
    a = np.linspace(-1, 1, 5)
    b = np.linspace(0, 2, 4)
    c = np.linspace(-3, 3, 7)
    A, B, C = np.meshgrid(a, b, c, indexing="ij")
    inputs = np.stack([A, B, C], axis=-1).reshape(-1, 3)
    outputs = np.stack([inputs.sum(1), inputs[:, 0] * 2], axis=-1)
    return inputs, outputs


def test_grid_lookup_exact_snap_and_invalid():
    inputs, outputs = _toy_table()
    table = te.grid_table_from_arrays(inputs, outputs, device="cpu")
    out, valid = te.grid_lookup(table, torch.as_tensor(inputs,
                                                       dtype=torch.float32))
    np.testing.assert_allclose(out.numpy(), outputs, rtol=1e-5)
    assert bool(valid.all())
    out, _ = te.grid_lookup(table, torch.tensor([[0.51, 0.6, 1.1]]))
    assert float(out[0, 0]) == pytest.approx(0.5 + 2 / 3 + 1.0, abs=1e-5)
    bad = outputs.copy()
    bad[10] = -999.0
    table = te.grid_table_from_arrays(inputs, bad, device="cpu")
    _, valid = te.grid_lookup(table, torch.as_tensor(inputs[10:11],
                                                     dtype=torch.float32))
    assert not bool(valid[0])


def test_nn_lookup_matches_grid():
    inputs, outputs = _toy_table()
    gt = te.grid_table_from_arrays(inputs, outputs, device="cpu")
    nt = te.nn_table_from_arrays(inputs, outputs, device="cpu")
    q = torch.as_tensor(np.random.default_rng(0).uniform(
        [-1, 0, -3], [1, 2, 3], (32, 3)), dtype=torch.float32)
    go, _ = te.grid_lookup(gt, q)
    no, _ = te.nn_lookup(nt, q)
    np.testing.assert_allclose(no.numpy(), go.numpy(), rtol=1e-5, atol=1e-5)


def test_grid_lookup_linear_interpolates():
    xs = np.linspace(0.0, 1.0, 5)
    ys = np.linspace(-2.0, 2.0, 4)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    inputs = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
    out = (3.0 * inputs[:, :1] - 0.5 * inputs[:, 1:] + 1.0).astype(np.float32)
    table = te.grid_table_from_arrays(inputs, out, device="cpu")
    q = np.asarray([[0.3, 0.7], [0.99, -1.99], [0.5, 0.0]], np.float32)
    got, valid = te.grid_lookup_linear(table, torch.as_tensor(q))
    want = 3.0 * q[:, :1] - 0.5 * q[:, 1:] + 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert bool(valid.all())
    a, _ = te.grid_lookup_linear(table, torch.as_tensor(inputs[7:9]))
    b, _ = te.grid_lookup(table, torch.as_tensor(inputs[7:9]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    out_bad = out.copy()
    out_bad[6] = -999.0
    got2, valid2 = te.grid_lookup_linear(te.grid_table_from_arrays(
        inputs, out_bad, device="cpu"), torch.as_tensor(q))
    assert np.all(got2.numpy() > -100) and bool(valid2.all())
    _, valid3 = te.grid_lookup_linear(te.grid_table_from_arrays(
        inputs, np.full_like(out, -999.0), device="cpu"), torch.as_tensor(q))
    assert not bool(valid3.any())


def test_grid_lookup_linear_singleton_axis():
    xs = np.linspace(0.0, 1.0, 5)
    gx, gy = np.meshgrid(xs, np.asarray([2.0]), indexing="ij")
    inputs = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
    out = (10.0 * inputs[:, :1] + inputs[:, 1:]).astype(np.float32)
    table = te.grid_table_from_arrays(inputs, out, device="cpu")
    q = np.asarray([[0.5, 2.0], [0.9, 1.0], [0.1, 3.0]], np.float32)
    got, valid = te.grid_lookup_linear(table, torch.as_tensor(q))
    np.testing.assert_allclose(got.numpy(), 10.0 * q[:, :1] + 2.0, rtol=1e-5,
                               atol=1e-5)
    assert bool(valid.all())


def _frenet_toy_table():
    ey = np.linspace(-0.5, 0.5, 3)
    other = [np.linspace(-0.1, 0.1, 2)] * 7
    grids = np.meshgrid(ey, *other, indexing="ij")
    inputs = np.stack([g.reshape(-1) for g in grids], axis=-1)
    return inputs, np.tile(inputs[:, :1], (1, 10))  # accel pattern = ey


@pytest.mark.parametrize("mode", ["linear", "nearest", "nn"])
def test_explicit_frenet_planner_matches_jax(mode):
    inputs, outputs = _frenet_toy_table()
    jtrack = joval(n_samples=256)
    ttrack = oval_track(n_samples=256, device="cpu")
    if mode == "nn":
        jtab = je.nn_table_from_arrays(inputs, outputs)
        ttab = te.nn_table_from_arrays(inputs, outputs, device="cpu")
    else:
        jtab, ttab = both_tables(inputs, outputs)
    kw = dict(interpolate=mode == "linear")
    jp = je.ExplicitFrenetPlanner(jtab, jtrack, **kw)
    tp = te.ExplicitFrenetPlanner(ttab, ttrack, **kw)
    rng = np.random.default_rng(3)
    n = 16
    args = dict(s=rng.uniform(0, 60, n), ey=rng.uniform(-0.6, 0.6, n),
                epsi=rng.uniform(-0.1, 0.1, n), delta=rng.uniform(-.1, .1, n),
                vx=rng.uniform(-0.1, 0.1, n), vy=rng.uniform(-0.1, 0.1, n),
                wz=rng.uniform(-0.1, 0.1, n))
    args = {k: v.astype(np.float32) for k, v in args.items()}
    jo, jv = jp.plan_batch(**{k: jnp.asarray(v) for k, v in args.items()})
    to, tv = tp.plan_batch(**{k: torch.as_tensor(v) for k, v in args.items()})
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the raceline is f32 in both packages and agrees to its last place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    out, valid = tp.plan_batch(
        s=torch.tensor([5.0]), ey=torch.tensor([0.5]),
        epsi=torch.tensor([0.0]), delta=torch.zeros(1), vx=torch.zeros(1),
        vy=torch.zeros(1), wz=torch.zeros(1))
    assert bool(valid[0]) and float(out[0, 0]) == pytest.approx(0.5,
                                                                abs=1e-6)


def test_explicit_planner_obs_api_and_infeasible_cell_coasts():
    inputs, outputs = _frenet_toy_table()
    track = oval_track(n_samples=256, device="cpu")
    obs = {"pose_x": 0.0, "pose_y": -7.4, "pose_theta": 0.0, "delta": 0.0,
           "linear_vel_x": 0.05, "linear_vel_y": 0.0, "ang_vel_z": 0.0}
    planner = te.ExplicitFrenetPlanner(
        te.grid_table_from_arrays(inputs, outputs, device="cpu"), track)
    a, sv = planner.plan(obs)
    assert np.isfinite(a) and np.isfinite(sv) and isinstance(a, float)
    dead = te.ExplicitFrenetPlanner(te.grid_table_from_arrays(
        inputs, np.full_like(outputs, -999.0), device="cpu"), track)
    assert dead.plan(obs) == (0.0, 0.0)


def test_adaptive_explicit_planner():
    inputs, outputs = _frenet_toy_table()
    track = oval_track(n_samples=256, device="cpu")
    planners = [te.ExplicitFrenetPlanner(te.grid_table_from_arrays(
        inputs, outputs * k, device="cpu"), track) for k in (1.0, 2.0)]
    ad = te.AdaptiveExplicitPlanner(planners, gamma=0.3, seed=1)
    obs = {"pose_x": 0.0, "pose_y": -7.0, "pose_theta": 0.0, "delta": 0.0,
           "linear_vel_x": 0.05, "linear_vel_y": 0.0, "ang_vel_z": 0.0}
    arms = set()
    for _ in range(12):
        arm = ad.select()
        arms.add(arm)
        assert ad.plan(obs) == planners[arm].plan(obs)
        ad.reward(1.0 if arm == 1 else 0.0)
    assert arms == {0, 1}
    assert ad.bandit.weights[1] > ad.bandit.weights[0]


# ------------------------------------------------------------- the bandit

@pytest.mark.parametrize("rew_scale", [0.5, None])
def test_exp3_state_functions_match_jax(rew_scale):
    """The same arms and rewards give the same probabilities and weights
    (f32; exp and sigmoid differ in the last place between the libraries)."""
    rng = np.random.default_rng(0)
    n = 5
    js, ts = jb.exp3_init(n, 0.2), tb.exp3_init(n, 0.2)
    for _ in range(40):
        jp, tp = jb.exp3_probs(js), tb.exp3_probs(ts)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
        assert float(tp.sum()) == pytest.approx(1.0, abs=1e-6)
        arm = int(rng.integers(0, n))
        r = float(rng.uniform(-0.5, 1.5))
        js = jb.exp3_update(js._replace(last_probs=jp), arm, r, rew_scale)
        ts = tb.exp3_update(ts._replace(last_probs=tp), arm, r, rew_scale)
        np.testing.assert_allclose(ts.weights.numpy(),
                                   np.asarray(js.weights), rtol=1e-5)
    assert float(ts.weights.max()) == 1.0


def test_exp3_object_api_follows_jax_on_the_same_arms():
    """The JAX bandit's own pulls (its seed) and rewards, replayed through
    the port's update: the same weights."""
    jx, tx = jb.EXP3(4, 0.2, seed=3), tb.EXP3(4, 0.2, seed=3)
    rng = np.random.default_rng(1)
    for _ in range(30):
        arm = jx.pull_arm()
        tx.state = tx.state._replace(last_probs=tb.exp3_probs(tx.state))
        r = float(rng.random()) * (1.5 if arm == 2 else 0.5)
        jx.update_dist(arm, r, None)
        tx.update_dist(arm, r, None)
    np.testing.assert_allclose(tx.weights, jx.weights, rtol=1e-4)
    assert int(np.argmax(tx.weights)) == 2


def test_exp3_pulls_follow_the_distribution_and_seed():
    a, b = tb.EXP3(3, 0.3, seed=5), tb.EXP3(3, 0.3, seed=5)
    a.state = a.state._replace(weights=torch.tensor([1.0, 0.2, 0.05]))
    b.state = a.state
    pulls = [a.pull_arm() for _ in range(3000)]
    assert pulls[:50] == [b.pull_arm() for _ in range(50)]
    freq = np.bincount(pulls, minlength=3) / len(pulls)
    np.testing.assert_allclose(freq, tb.exp3_probs(a.state).numpy(),
                               atol=0.03)
    np.testing.assert_allclose(a.state.last_probs.numpy(),
                               tb.exp3_probs(a.state).numpy())
    a.reset()
    np.testing.assert_array_equal(a.weights, np.ones(3, np.float32))
