"""PyTorch port of the batched NMPC solver vs the JAX package.

One module-scoped fixture solves the 39 rows the JAX package's own solver
tests share (at-goal, saturation, mirror pair, warm-start row, 32 random
rows, two perturbation-gold rows) with ``solve_lattice_point`` in f64 in
both packages: that is this file's one JAX solver compile. Everything else
is held against it, against the stored oracles under ``tests/oracles/``, or
piece by piece against JAX functions that compile in seconds.

Tolerances: two f64 implementations of the same iteration differ by
rounding that the iteration amplifies (measured ~1e-7 in a control on
marginal rows), so controls and states are held to ``TOL_SOLUTION`` on rows
both call feasible; ``feasible`` and the activation one-hot are compared on
every row whose JAX KKT residual lies outside ``KKT_BAND`` around ``kkt_tol``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics.params import f1tenth_params as jf1tenth
from irbfn_tpu.dynamics.params import fullscale_params as jfullscale
from irbfn_tpu.parallel import datagen as jdatagen
from irbfn_tpu.solvers import nmpc as J
from irbfn_tpu_torch.dynamics.params import (VehicleParams, f1tenth_params,
                                             fullscale_params)
from irbfn_tpu_torch.parallel import datagen
from irbfn_tpu_torch.solvers import nmpc as T
from irbfn_tpu_torch.solvers.oracle import (compare_to_oracle, load_oracle,
                                            make_problem_fns, save_oracle,
                                            solve_oracle_rows)

torch.set_num_threads(1)
ORACLES = Path(__file__).parent / "oracles"
TOL_SOLUTION = 1e-6  # controls and states, rows feasible in both
TOL_SAME_COST = 1e-9  # relative objective of a row that took another path
KKT_BAND = 0.2  # flags compared where |kkt / kkt_tol - 1| > KKT_BAND
TOL_PIECE = 1e-10  # rollout, costs and derivatives, f64

_I_AT_GOAL, _I_SAT, _I_MIRROR, _I_MIRROR_NEG, _I_WARM = 0, 1, 2, 3, 4
_I_RNG = slice(5, 37)
_I_PERT = slice(37, 39)


def shared_rows() -> np.ndarray:
    """The 39 rows of the JAX package's shared-batch solver tests."""
    mirror = np.array([0.4, 0.1, 5.0, 0.2, 6.0, 0.5, 0.3, 0.05])
    rng = np.random.default_rng(7)
    n = 32
    rng_rows = np.column_stack([
        rng.uniform(-0.2, 2.0, n), rng.uniform(-0.3, 0.3, n),
        rng.uniform(1.0, 7.0, n), rng.uniform(-1.0, 1.0, n),
        rng.uniform(3.0, 7.0, n), rng.uniform(-2.6, 2.6, n),
        rng.uniform(-1.0, 1.0, n), rng.uniform(-0.1, 0.1, n)])
    return np.vstack([
        [0.0, 0.0, 5.0, 0.0, 5.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 3.0, 0.0, 7.0, 0.0, 0.0, 0.0],
        mirror,
        mirror * np.array([-1, -1, 1, -1, 1, -1, -1, -1]),
        [0.5, 0.0, 5.0, 0.0, 6.0, 0.0, 0.1, 0.02],
        rng_rows,
        [[0.3, 0.05, 4.0, -0.1, 5.0, 0.4, 0.15, 0.03],
         [1.0, -0.1, 2.5, 0.3, 6.0, -1.0, -0.4, -0.08]],
    ])


def random_rows(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-0.2, 2.0, n), rng.uniform(-0.3, 0.3, n),
        rng.uniform(1.0, 7.0, n), rng.uniform(-1.0, 1.0, n),
        rng.uniform(3.0, 7.0, n), rng.uniform(-2.6, 2.6, n),
        rng.uniform(-1.0, 1.0, n), rng.uniform(-0.1, 0.1, n)])


def problem(rows):
    """(x0, goal, curv) numpy arrays of lattice rows."""
    x0 = np.column_stack([np.zeros(len(rows)), rows[:, 0], rows[:, 1],
                          rows[:, 2], rows[:, 3], rows[:, 5], rows[:, 6]])
    goal = np.zeros((len(rows), 7))
    goal[:, 3] = rows[:, 4]
    return x0, goal, rows[:, 7].copy()


def tp64(**kw) -> VehicleParams:
    return fullscale_params(dtype=torch.float64, device="cpu", **kw)


def t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def sol_np(sol) -> dict:
    return {k: np.asarray(v) for k, v in sol._asdict().items()}


@pytest.fixture(scope="module")
def both():
    rows = shared_rows()
    jsol = J.solve_lattice_point(jnp.asarray(rows), jfullscale(
        mu=1.0, cs=5.0, dtype=jnp.float64), J.NMPCConfig())
    tsol = T.solve_lattice_point(t64(rows), tp64(), T.NMPCConfig())
    return rows, sol_np(jsol), sol_np(tsol), tsol


# ------------------------------------------------ the solver against JAX

def test_config_defaults_match():
    import dataclasses

    for make_j, make_t in ((J.NMPCConfig, T.NMPCConfig),
                           (J.cartesian_config, T.cartesian_config),
                           (J.kinematic_config, T.kinematic_config)):
        assert dataclasses.asdict(make_j()) == dataclasses.asdict(make_t())
    assert (dataclasses.asdict(T.cartesian_config(max_speed=5.0))
            == dataclasses.asdict(J.cartesian_config(max_speed=5.0)))


def test_solutions_match_jax(both):
    rows, j, t, _ = both
    feas = j["feasible"] & t["feasible"]
    assert feas.sum() >= 34
    err = np.maximum.reduce([
        np.abs(j["accel"] - t["accel"]).max(-1),
        np.abs(j["steer_vel"] - t["steer_vel"]).max(-1),
        np.abs(j["states"] - t["states"]).max((-1, -2))])
    off = np.nonzero(feas & (err > TOL_SOLUTION))[0]
    assert off.size <= 1, f"rows {off} differ by {err[off]}"
    if off.size:  # another path to the same cost
        x0, goal, curv = problem(rows[off])
        costs = [float(T._smooth_cost(
            t64(np.stack([s["accel"][off[0]], s["steer_vel"][off[0]]],
                         -1).reshape(1, -1)),
            t64(x0), t64(goal), t64(curv), tp64(), T.NMPCConfig())[0])
            for s in (j, t)]
        assert abs(costs[0] - costs[1]) <= TOL_SAME_COST * abs(costs[0])


def test_feasible_flags_and_onehot_match_jax(both):
    _, j, t, _ = both
    kkt_tol = T.NMPCConfig().kkt_tol
    clear = np.abs(j["kkt_residual"] / kkt_tol - 1.0) > KKT_BAND
    assert clear.sum() >= 37
    np.testing.assert_array_equal(j["feasible"][clear], t["feasible"][clear])
    same = clear & j["feasible"]
    np.testing.assert_array_equal(j["active_onehot"][same],
                                  t["active_onehot"][same])
    assert t["active_onehot"].shape == (39, 86)
    assert t["states"].shape == (39, 6, 7)


def test_at_goal_zero_controls(both):
    _, _, t, _ = both
    np.testing.assert_allclose(t["accel"][_I_AT_GOAL], 0.0, atol=1e-8)
    np.testing.assert_allclose(t["steer_vel"][_I_AT_GOAL], 0.0, atol=1e-8)
    assert t["feasible"][_I_AT_GOAL]


def test_accel_saturation_and_onehot(both):
    _, _, t, _ = both
    cfg = T.NMPCConfig()
    a = t["accel"][_I_SAT]
    assert a[0] == pytest.approx(cfg.max_accel, abs=1e-6)
    assert a[1] == pytest.approx(cfg.max_accel, abs=1e-6)
    onehot = t["active_onehot"][_I_SAT]
    np.testing.assert_array_equal(onehot[42:47], 1)
    assert onehot[47] == 0 and onehot[48] == 0


def test_full_mirror_symmetry(both):
    _, _, t, _ = both
    np.testing.assert_allclose(t["accel"][_I_MIRROR],
                               t["accel"][_I_MIRROR_NEG], atol=1e-5)
    np.testing.assert_allclose(t["steer_vel"][_I_MIRROR],
                               -t["steer_vel"][_I_MIRROR_NEG], atol=1e-5)


def test_batch_constraint_satisfaction(both):
    _, _, t, _ = both
    cfg = T.NMPCConfig()
    a, sv = t["accel"][_I_RNG], t["steer_vel"][_I_RNG]
    assert (np.abs(a) <= cfg.max_accel + 1e-9).all()
    assert (np.abs(sv) <= cfg.max_dsteer + 1e-9).all()
    xs, feas = t["states"][_I_RNG], t["feasible"][_I_RNG]
    assert feas.mean() >= 0.85
    assert (np.abs(xs[feas, 1:, 2]) <= cfg.max_steer + 1e-3).all()
    assert (xs[feas, 1:, 3] <= cfg.max_speed + 1e-3).all()
    assert (xs[feas, 1:, 3] >= cfg.min_speed - 1e-3).all()
    assert t["kkt_residual"][_I_RNG][feas].max() < 1e-2


def test_perturbation_gold(both):
    """The port reproduces the stored proven-optimal controls."""
    rows, _, t, _ = both
    gold = np.load(ORACLES / "nmpc_pert_gold.npz")
    np.testing.assert_allclose(rows[_I_PERT], gold["rows"], rtol=0, atol=0)
    u_live = np.stack([t["accel"][_I_PERT], t["steer_vel"][_I_PERT]],
                      -1).reshape(gold["u_star"].shape)
    assert t["feasible"][_I_PERT].all()
    np.testing.assert_allclose(u_live, gold["u_star"], atol=1e-5)


def test_warm_start_is_a_fixed_point(both):
    rows, _, t, tsol = both
    x0, goal, curv = problem(rows)
    u_init = torch.stack([tsol.accel, tsol.steer_vel], dim=-1)
    sol2 = sol_np(T.solve_nmpc_batch(t64(x0), t64(goal), t64(curv), tp64(),
                                     T.NMPCConfig(), u_init=u_init))
    feas = t["feasible"] & sol2["feasible"]
    assert feas.sum() >= 30
    du = np.abs(sol2["accel"] - t["accel"]).max(-1)
    dsv = np.abs(sol2["steer_vel"] - t["steer_vel"]).max(-1)
    assert du[_I_WARM] < 1e-6 and dsv[_I_WARM] < 1e-6
    match = (du[feas] < 1e-6) & (dsv[feas] < 1e-6)
    assert match.mean() >= 0.9


def test_multi_params_sweep_matches_single(both):
    rows, _, t, _ = both
    mus = [0.6, 1.0]
    singles = [tp64(mu=m) for m in mus]
    pb = VehicleParams(*[torch.stack(f) for f in
                         zip(*[p.fields() for p in singles])])
    multi = sol_np(T.solve_lattice_multi_params(t64(rows), pb))
    assert multi["accel"].shape == (2, 39, 5)
    single06 = sol_np(T.solve_lattice_point(t64(rows), singles[0]))
    # rows do not see each other; a larger batch only reorders the
    # library's vectorised sums (measured 2e-13 after one solve), which the
    # iteration amplifies on rows it cannot settle (measured 3.5e-5 on a
    # row flagged infeasible): feasible rows are held to TOL_SOLUTION
    for i, single in enumerate([single06, t]):
        np.testing.assert_array_equal(multi["feasible"][i],
                                      single["feasible"])
        feas = single["feasible"]
        assert feas.sum() >= 30
        np.testing.assert_allclose(multi["accel"][i][feas],
                                   single["accel"][feas], rtol=0,
                                   atol=TOL_SOLUTION)
        np.testing.assert_allclose(multi["steer_vel"][i][feas],
                                   single["steer_vel"][feas], rtol=0,
                                   atol=TOL_SOLUTION)


def test_cheap_cap_certificate_is_budget_independent():
    cfg1 = T.NMPCConfig(gn_iters=12)
    sol = sol_np(T.solve_lattice_point(t64(random_rows(3, 24)), tp64(), cfg1))
    feas = sol["feasible"]
    assert feas.mean() >= 0.7
    assert sol["kkt_residual"][feas].max() < cfg1.kkt_tol
    xs = sol["states"][feas]
    assert (np.abs(xs[:, 1:, 2]) <= cfg1.max_steer + 1e-3).all()
    assert (xs[:, 1:, 3] <= cfg1.max_speed + 1e-3).all()
    assert (xs[:, 1:, 3] >= cfg1.min_speed - 1e-3).all()


# ----------------------------------------------- the stored SLSQP oracle

@pytest.fixture(scope="module")
def oracle_metrics():
    rows, oracle = load_oracle(ORACLES / "nmpc_frenet_slsqp.npz")
    return compare_to_oracle(rows, tp64(), T.NMPCConfig(), oracle=oracle,
                             device="cpu")


def test_oracle_feasible_set_overlap(oracle_metrics):
    m = oracle_metrics
    assert m["oracle_feasible"] >= 0.9 * m["n_rows"]
    assert m["both_feasible"] >= 0.9 * m["oracle_feasible"]
    assert m["oracle_misses_al_feasible"] <= max(1, m["n_rows"] // 33)


def test_oracle_objective_agreement(oracle_metrics):
    assert oracle_metrics["rel_obj_gap_p50"] < 1e-10
    assert oracle_metrics["rel_obj_gap_p90"] < 1e-4


def test_oracle_control_agreement(oracle_metrics):
    assert oracle_metrics["du_max_p50"] < 1e-4
    assert oracle_metrics["du_rel_p90"] < 5e-2


def test_live_slsqp_and_oracle_file_roundtrip(tmp_path):
    """The port's SLSQP oracle solves two stored rows to the stored
    solutions, and its file loads in the JAX package's loader."""
    from irbfn_tpu.solvers.oracle import load_oracle as jload

    rows, stored = load_oracle(ORACLES / "nmpc_frenet_slsqp.npz")
    idx = np.nonzero(stored.feasible)[0][:2]
    live = solve_oracle_rows(rows[idx], tp64())
    assert live.feasible.all()
    np.testing.assert_allclose(live.objective, stored.objective[idx],
                               rtol=1e-8)
    np.testing.assert_allclose(live.u, stored.u[idx], atol=1e-6)
    path = tmp_path / "oracle.npz"
    save_oracle(path, rows[idx], live, seed=7)
    rows2, again = jload(path)
    np.testing.assert_array_equal(rows2, rows[idx])
    np.testing.assert_array_equal(again.u, live.u)
    vg, cons, jac = make_problem_fns(tp64(), T.NMPCConfig())
    x0, goal, curv = (t64(a[0]) for a in problem(rows[idx[:1]]))
    v, g = vg(t64(live.u[0].reshape(-1)), x0, goal, curv)
    assert float(v) == pytest.approx(live.objective[0], rel=1e-12)
    assert g.shape == (10,) and jac(t64(live.u[0].reshape(-1)), x0,
                                    curv).shape == (24, 10)


# --------------------------------------- the loop's masks and rejections

SMALL = T.NMPCConfig(gn_iters=6, al_outer=2)


def test_rows_of_a_batch_solve_as_they_do_alone():
    """An easy row (converges, is frozen, the loop goes on) and a hard row
    (runs to the cap) give, row by row, what each gives alone."""
    rows = np.array([[0.0, 0.0, 5.0, 0.0, 5.0, 0.0, 0.0, 0.0],
                     [1.9, 0.3, 7.0, -1.0, 3.0, 2.6, -1.0, 0.1]])
    pair = sol_np(T.solve_lattice_point(t64(rows), tp64(), SMALL))
    iters_pair = T.LAST_SOLVE_STATS["newton_iterations"]
    iters_alone = []
    for i in range(2):
        alone = sol_np(T.solve_lattice_point(t64(rows[i:i + 1]), tp64(),
                                             SMALL))
        iters_alone.append(T.LAST_SOLVE_STATS["newton_iterations"])
        for k in pair:  # up to the batch size's effect on vectorised sums
            np.testing.assert_allclose(pair[k][i], alone[k][0], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    # the easy row ends early alone; the pair runs as long as the hard row
    # (whose convergence test, at 100 eps, may fire one pass apart in the
    # two batch sizes)
    assert iters_alone[0] < iters_alone[1]
    assert abs(iters_pair - iters_alone[1]) <= 1


def _iteration_state(rows, cfg=T.NMPCConfig()):
    x0, goal, curv = (t64(a) for a in problem(rows))
    B = len(rows)
    lo, hi = T._control_bounds(cfg, torch.float64)
    prob = (x0, goal, curv, tp64(), lo.repeat(5), hi.repeat(5))
    u = torch.zeros(B, 10, dtype=torch.float64)
    xs = T._rollout_rk4(x0, T._controls(u, cfg), curv, tp64(), cfg)
    mu = torch.full((B,), 1e-4, dtype=torch.float64)
    done = torch.zeros(B, dtype=torch.bool)
    lam = torch.zeros(B, 24, dtype=torch.float64)
    rho = torch.tensor(cfg.penalty0, dtype=torch.float64)
    return u, xs, mu, done, lam, rho, prob


def test_indefinite_hessian_rejects_step_and_grows_damping(monkeypatch):
    """Row 0 gets an indefinite Hessian: its Cholesky fails, its step is
    NaN, the line search rejects it, mu grows tenfold and u stays; row 1,
    beside it, takes its Newton step as it does alone."""
    rows = shared_rows()[[_I_WARM, _I_SAT]]
    cfg = T.NMPCConfig()
    u, xs, mu, done, lam, rho, prob = _iteration_state(rows, cfg)
    with torch.no_grad():
        want = T._newton_iteration(u, xs, mu, done, lam, rho, prob, cfg)
    real = T._fused_derivatives

    def indefinite(*a, **k):
        H_s, Jw, v, gs, w = real(*a, **k)
        H_s = H_s.clone()
        H_s[0] = -torch.eye(10, dtype=H_s.dtype)
        return H_s, Jw, v, gs, w

    monkeypatch.setattr(T, "_fused_derivatives", indefinite)
    with torch.no_grad():
        u1, xs1, mu1, done1 = T._newton_iteration(u, xs, mu, done, lam, rho,
                                                  prob, cfg)
    assert torch.equal(u1[0], u[0]) and torch.equal(xs1[0], xs[0])
    assert float(mu1[0]) == pytest.approx(1e-3) and not bool(done1[0])
    assert torch.equal(u1[1], want[0][1]) and not torch.equal(u1[1], u[1])
    assert float(mu1[1]) == pytest.approx(2e-5)


def test_solve_spd_flags_only_the_bad_rows():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 10, 10))
    A = t64(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(10))
    A[1] = -A[1]  # negative definite
    A[2, 3, 3] = float("nan")
    b = t64(rng.normal(size=(4, 10)))
    x = T._solve_spd(A, b)
    assert torch.isnan(x[1]).all() and torch.isnan(x[2]).all()
    for i in (0, 3):
        np.testing.assert_allclose((A[i] @ x[i]).numpy(), b[i].numpy(),
                                   atol=1e-9)


def test_solve_spd_is_the_jax_package_s_unrolled_cholesky():
    """The same column order and pivots as ``_solve_spd_unrolled``: equal to
    rounding in f64, and a pivot refused (a non-finite step) in the same
    rows, those of an indefinite or a singular matrix among them."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 10, 10))
    A = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(10)
    A[:8] -= 2.0 * np.eye(10)  # some indefinite
    A[8] = np.outer(a[8, 0], a[8, 0])  # rank one: a zero pivot
    b = rng.normal(size=(64, 10))
    want = np.asarray(jax.vmap(J._solve_spd_unrolled)(jnp.asarray(A),
                                                      jnp.asarray(b)))
    got = T._solve_spd(t64(A), t64(b)).numpy()
    ok = np.isfinite(want).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), ok)
    assert 0 < ok.sum() < 64
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10, atol=1e-12)


CHEAP_GOLDEN = (Path(__file__).parents[1] / "irbfn_tpu_torch" / "assets"
                / "cheap_pass_golden.npz")
# the cheap pass in f32 at the 39-row shape: flags that may differ from the
# JAX package's. Measured (scripts/export_torch_ckpt.py --cheap_pass_check):
# near its 12-iteration cap the f32 iteration of a few percent of the rows
# is decided by rounding (a line-search candidate that ties the current
# objective in f32 is taken or refused); the JAX package against itself
# differs on 1 of these 39 rows when solved in another batch, and on 9 of
# the 312 (2.9%) when its iteration is written as a Python loop; the port
# differs on 3 of the 39.
TOL_CHEAP_FLAGS = 4


def test_cheap_pass_f32_at_39_rows_matches_jax():
    """The tiered generator's cheap pass (12 Newton iterations) on the 39
    rows of ``cheap_pass_golden.npz``, among them the seven whose f32 flags
    parted from the JAX package's in the 312-row check: in f32 the port
    certifies at least as many rows as the JAX package less one, and its
    flags differ on at most ``TOL_CHEAP_FLAGS``; in f64 every flag is the
    JAX package's."""
    with np.load(CHEAP_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    idx = g["test_idx"]
    assert {20, 66, 67, 102, 128, 161, 175} <= set(idx.tolist())
    assert idx.size == 39
    cfg = T.NMPCConfig(gn_iters=12)
    rows = g["rows"][idx]
    sol = T.solve_lattice_point(
        torch.as_tensor(rows, dtype=torch.float32),
        fullscale_params(dtype=torch.float32, device="cpu"), cfg)
    flags, want = sol.feasible.numpy(), g["test_flags_f32"]
    assert flags.sum() >= want.sum() - 1, (flags.sum(), want.sum())
    assert (flags != want).sum() <= TOL_CHEAP_FLAGS, idx[flags != want]
    sol64 = T.solve_lattice_point(t64(rows), tp64(), cfg)
    np.testing.assert_array_equal(sol64.feasible.numpy(),
                                  g["flags_f64"][idx])


@pytest.mark.parametrize("case", ["nan_at_best", "all_nan_step", "nan_f_old"])
def test_line_search_rejects_nan_and_inf(case):
    """What JAX's argmin/minimum/< do with NaN and inf: a NaN objective at
    a finite candidate wins the argmin and is then refused by ``<``; a NaN
    step makes every candidate +inf; a NaN current objective accepts
    nothing."""
    cfg = T.NMPCConfig()
    lo, hi = T._control_bounds(cfg, torch.float64)
    lo, hi = lo.repeat(5), hi.repeat(5)
    u = torch.zeros(1, 10, dtype=torch.float64)
    step = torch.ones(1, 10, dtype=torch.float64)
    f_old = torch.tensor([1.0], dtype=torch.float64)
    f_c = torch.linspace(0.9, 0.2, 8, dtype=torch.float64)[None].clone()
    if case == "nan_at_best":
        f_c[0, 3] = float("nan")
    elif case == "all_nan_step":
        step = step * float("nan")
    else:
        f_old = f_old * float("nan")

    def obj(c):
        return f_c.clone(), torch.zeros(1, 8, 6, 7, dtype=torch.float64)

    c_best, _, f_best = T._line_search(u, step, obj, lo, hi, cfg)
    improved = f_best < f_old
    assert not bool(improved[0])
    f_j = jnp.where(jnp.all(jnp.isfinite(jnp.asarray(
        (u[:, None] - 0.5 ** torch.arange(8.0, dtype=torch.float64)[
            None, :, None] * step[:, None]).numpy()[0])), axis=1),
        jnp.asarray(f_c.numpy()[0]), jnp.inf)
    best_j = int(jnp.argmin(f_j))
    f_new_j = jnp.minimum(f_j[best_j], f_old.numpy()[0])
    assert not bool(f_new_j < f_old.numpy()[0])
    if case == "nan_at_best":
        assert best_j == 3 and bool(torch.isnan(f_best[0]))
    if case == "all_nan_step":
        assert bool(torch.isinf(f_best[0]))


def test_objective_nan_at_a_finite_candidate_is_rejected():
    """1 - ey*curv crosses 0 inside the horizon for this row: the rollout
    is not finite at finite controls, and the iteration keeps u."""
    rows = np.array([[2.0, 0.0, 5.0, 0.0, 5.0, 0.0, 1.5, 0.5]])
    cfg = T.NMPCConfig()
    u, xs, mu, done, lam, rho, prob = _iteration_state(rows, cfg)
    x0, goal, curv = prob[:3]
    bad_u = torch.zeros(1, 10, dtype=torch.float64)
    # ey' = vx sin(epsi): ey reaches 1/curv = 2 at once, the s-dot
    # denominator passes through 0 and the cost overflows or is NaN
    f = T._objective(bad_u, x0 + t64([[0, 1e-12, 0, 0, 0, 0, 0]]), goal,
                     curv, lam, rho, tp64(), cfg)
    with torch.no_grad():
        u1, xs1, mu1, _ = T._newton_iteration(u, xs, mu, done, lam, rho,
                                              prob, cfg)
    assert bool(torch.isfinite(u1).all())
    if not bool(torch.isfinite(f).all()):
        assert torch.equal(u1, u) and float(mu1[0]) == pytest.approx(1e-3)


# ------------------------------------------- the pieces, one by one, f64

def _points(n=4, seed=11):
    rng = np.random.default_rng(seed)
    rows = random_rows(seed, n)
    x0, goal, curv = problem(rows)
    u = rng.normal(0.0, 1.0, (n, 10)) * np.tile([3.0, 1.0], 5)
    lam = np.abs(rng.normal(0.0, 1.0, (n, 24)))
    # close to the walls, so that some hinges are open
    x0[:, 2] = rng.uniform(0.3, 0.41, n) * rng.choice([-1, 1], n)
    return u, x0, goal, curv, lam


@pytest.mark.parametrize("model", ["frenet", "cartesian", "kinematic"])
def test_rollout_and_costs_match_jax(model):
    make = {"frenet": (J.NMPCConfig, T.NMPCConfig),
            "cartesian": (J.cartesian_config, T.cartesian_config),
            "kinematic": (J.kinematic_config, T.kinematic_config)}[model]
    jcfg, tcfg = make[0](), make[1]()
    jp = (jfullscale if model == "frenet" else jf1tenth)(dtype=jnp.float64)
    tp = (fullscale_params if model == "frenet" else f1tenth_params)(
        dtype=torch.float64, device="cpu")
    u, x0, goal, curv, lam = _points()
    if model != "frenet":
        goal[:, :2] = np.random.default_rng(1).uniform(0.5, 2.0, (len(u), 2))
    rho = 400.0

    @jax.jit
    def jfn(u, x0, goal, curv, lam):
        one = lambda u, x0, goal, curv, lam: (  # noqa: E731
            J._rollout_rk4(x0, u.reshape(5, 2), curv, jp, jcfg),
            J._smooth_cost(u, x0, goal, curv, jp, jcfg),
            J._wall_residuals(u, x0, curv, lam, rho, jp, jcfg),
            J._objective(u, x0, goal, curv, lam, rho, jp, jcfg))
        return jax.vmap(one)(u, x0, goal, curv, lam)

    want = [np.asarray(a) for a in jfn(*(jnp.asarray(a) for a in
                                         (u, x0, goal, curv, lam)))]
    tu, tx0, tgoal, tcurv, tlam = (t64(a) for a in (u, x0, goal, curv, lam))
    got = [T._rollout_rk4(tx0, T._controls(tu, tcfg), tcurv, tp, tcfg),
           T._smooth_cost(tu, tx0, tgoal, tcurv, tp, tcfg),
           T._wall_residuals(tu, tx0, tcurv, tlam, rho, tp, tcfg),
           T._objective(tu, tx0, tgoal, tcurv, tlam, rho, tp, tcfg)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL_PIECE,
                                   atol=TOL_PIECE)
    assert (want[2] > 0).any()  # an open hinge is among the points


def fused_derivatives_rollout(u, x0, goal, curv, lam, rho, p, cfg):
    """The JAX package's form of the derivative pass, in ``torch.func``:
    ONE forward-over-reverse pass through the whole rollout. Rows are
    independent, so the gradient of the costs' sum is each row's own, and
    the Jacobian against a shift ``d`` added to every row is every row's
    own. The oracle for ``T._fused_derivatives``."""
    from torch.func import grad, jacfwd

    def cost_sum(uu):
        uc = T._controls(uu, cfg)
        xs = T._rollout_rk4(x0, uc, curv, p, cfg)
        v = T._cost_of_states(xs, uc, goal, cfg)
        return v.sum(), (v, xs)

    def comb(d):
        gs, (v, xs) = grad(cost_sum, has_aux=True)(u + d)
        w = T._walls_of_states(xs, lam, rho, cfg)
        return (gs, w), (v, gs, w)

    (H_s, Jw), (v, gs, w) = jacfwd(comb, has_aux=True)(
        torch.zeros(u.shape[-1], dtype=u.dtype))
    return H_s, Jw, v, gs, w


def test_fused_derivative_pass_matches_jax():
    """The solver's derivative pass (one batched dynamics evaluation), the
    whole-rollout pass (the JAX package's form in torch.func) and JAX's own
    jacfwd agree."""
    jcfg, tcfg = J.NMPCConfig(), T.NMPCConfig()
    jp = jfullscale(dtype=jnp.float64)
    u, x0, goal, curv, lam = _points()
    rho = 400.0

    @jax.jit
    def jfn(u, x0, goal, curv, lam):
        def one(u, x0, goal, curv, lam):
            def comb(uu):
                v, gs = jax.value_and_grad(J._smooth_cost)(uu, x0, goal,
                                                           curv, jp, jcfg)
                w = J._wall_residuals(uu, x0, curv, lam, rho, jp, jcfg)
                return (gs, w), (v, gs, w)
            (H_s, Jw), (v, gs, w) = jax.jacfwd(comb, has_aux=True)(u)
            return H_s, Jw, v, gs, w
        return jax.vmap(one)(u, x0, goal, curv, lam)

    want = [np.asarray(a) for a in jfn(*(jnp.asarray(a) for a in
                                         (u, x0, goal, curv, lam)))]
    args = tuple(t64(a) for a in (u, x0, goal, curv, lam)) + (
        torch.tensor(rho, dtype=torch.float64), tp64(), tcfg)
    for fn in (T._fused_derivatives, fused_derivatives_rollout):
        got = fn(*args)
        for name, g, w in zip(("H_s", "Jw", "v", "gs", "w"), got, want):
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=TOL_PIECE * scale,
                                       err_msg=f"{fn.__name__} {name}")
    assert (want[1] != 0).any()


def test_fused_derivative_pass_with_terminal_cost_and_per_row_params():
    """Cartesian (terminal Qf) and per-row vehicle parameters: the
    solver's pass equals the whole-rollout pass."""
    cfg = T.cartesian_config()
    u, x0, goal, curv, lam = _points()
    n = len(u)
    base = f1tenth_params(dtype=torch.float64, device="cpu")
    p = base.replace(mu=t64(np.linspace(0.5, 1.1, n)),
                     C_Sf=t64(np.linspace(2.0, 9.0, n)))
    args = tuple(t64(a) for a in (u, x0, goal, curv * 0, lam)) + (
        torch.tensor(100.0, dtype=torch.float64), p, cfg)
    for g, w in zip(T._fused_derivatives(*args),
                    fused_derivatives_rollout(*args)):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL_PIECE * scale)


def test_activation_onehot_matches_jax_exactly():
    rng = np.random.default_rng(5)
    cfg = T.NMPCConfig()
    n = 16
    u = rng.uniform(-1, 1, (n, 5, 2)) * [cfg.max_accel, cfg.max_dsteer]
    u[rng.random((n, 5, 2)) < 0.3] *= 1e9  # push some onto the bounds
    u = np.clip(u, [-cfg.max_accel, -cfg.max_dsteer],
                [cfg.max_accel, cfg.max_dsteer])
    xs = rng.normal(size=(n, 6, 7))
    xs[..., 2] = np.clip(xs[..., 2], -cfg.max_steer, cfg.max_steer)
    xs[..., 3] = np.clip(5 + 6 * xs[..., 3], cfg.min_speed, cfg.max_speed)
    want = np.asarray(jax.vmap(lambda u, xs: J._activation_onehot(
        u, xs, None, J.NMPCConfig()))(jnp.asarray(u), jnp.asarray(xs)))
    got = T._activation_onehot(t64(u), t64(xs), None, cfg).numpy()
    assert got.shape == (n, 86) and 0 < got[:, 42:].mean() < 1
    np.testing.assert_array_equal(got, want)


# ------------------------------------- the other models (torch only)

_CART_ROWS = np.vstack([
    [2.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0],   # straight goal
    [2.0, 1.5, 1.0, 0.5, 2.0, 0.0, 0.0],   # lateral goal
    [2.0, 1.5, 1.0, 0.5, 2.0, 0.1, 0.3],
    [2.0, 1.5, -1.0, -0.5, 2.0, -0.1, -0.3],
    [0.5, 3.0, 0.0, 0.0, 6.0, 0.0, 0.0],   # accel saturation
])


def test_cartesian_variant():
    """The checks of the JAX package's cartesian tests, on the port."""
    cfg = T.cartesian_config()
    p = f1tenth_params(dtype=torch.float64, device="cpu")
    sol = sol_np(T.solve_cartesian_point(t64(_CART_ROWS), p, cfg))
    assert sol["feasible"][0] and sol["feasible"][1]
    np.testing.assert_allclose(sol["steer_vel"][0], 0.0, atol=1e-5)
    assert abs(sol["states"][0, -1, 0] - 1.0) < 0.35
    assert np.abs(sol["steer_vel"][1]).max() > 0.05
    assert sol["states"][1, -1, 1] > 0.05
    np.testing.assert_allclose(sol["accel"][2], sol["accel"][3], atol=1e-4)
    np.testing.assert_allclose(sol["steer_vel"][2], -sol["steer_vel"][3],
                               atol=1e-4)
    assert np.abs(sol["accel"][4]).max() <= cfg.max_accel + 1e-9
    assert sol["accel"][4, 0] == pytest.approx(cfg.max_accel, abs=1e-5)


def test_kinematic_variant_runs():
    p = f1tenth_params(dtype=torch.float64, device="cpu")
    sol = T.solve_cartesian_point(t64([[1.0, 2.0, 0.5, 0.3, 2.0, 0.0, 0.0]]),
                                  p, T.kinematic_config())
    assert bool(sol.feasible[0])


def test_unbatched_and_array_inputs():
    """A single problem (no batch axis) and array-like inputs with a named
    device; with no device named the inputs go to the card (none here)."""
    row = shared_rows()[_I_WARM]
    sol = T.solve_lattice_point(row, tp64(), SMALL, device="cpu")
    assert sol.accel.shape == (5,) and sol.states.shape == (6, 7)
    batch = T.solve_lattice_point(t64(row[None]), tp64(), SMALL)
    np.testing.assert_array_equal(sol.accel.numpy(), batch.accel[0].numpy())
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            T.solve_lattice_point(row, tp64(), SMALL)


# ------------------------------------------- the table's slice and file

def _made_up_solution(n=12, seed=2):
    rng = np.random.default_rng(seed)
    feas = rng.random(n) > 0.3
    feas[:2] = [True, False]
    return dict(accel=rng.normal(size=(n, 5)).astype(np.float32),
                steer_vel=rng.normal(size=(n, 5)).astype(np.float32),
                states=rng.normal(size=(n, 6, 7)).astype(np.float32),
                active_onehot=(rng.random((n, 86)) > 0.5).astype(np.float32),
                feasible=feas,
                kkt_residual=rng.random(n).astype(np.float32))


@pytest.mark.parametrize("include_onehot", [True, False])
def test_table_solution_and_frenet_table_match_jax(include_onehot, tmp_path):
    sol = _made_up_solution()
    rows = random_rows(4, 12).astype(np.float32)
    jsol = J.NMPCSolution(*[jnp.asarray(v) for v in sol.values()])
    tsol = T.NMPCSolution(*[torch.as_tensor(v) for v in sol.values()])
    jt = jdatagen.TableSolution.from_solution(jsol, include_onehot)
    tt = datagen.TableSolution.from_solution(tsol, include_onehot)
    assert tt.active_onehot.dtype == torch.bool
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = jdatagen.frenet_table(rows, jt)
    got = datagen.frenet_table(rows, tt)
    assert list(got) == list(want)
    assert ("constraints" in got) == include_onehot
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["outputs"][~sol["feasible"]] == -999.0).all()
    datagen.save_table(str(tmp_path / "t.npz"), got)
    with np.load(tmp_path / "t.npz") as z:
        assert sorted(z.files) == sorted(want)
        np.testing.assert_array_equal(z["outputs"], want["outputs"])


def test_grids_match_jax():
    for name in ("FRENET_GRID", "CLOTHOID_GRID"):
        got, want = getattr(datagen, name), getattr(jdatagen, name)
        assert [(g.name, g.lo, g.hi, g.num) for g in got] == [
            (g.name, g.lo, g.hi, g.num) for g in want]
