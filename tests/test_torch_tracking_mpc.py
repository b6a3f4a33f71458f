"""PyTorch port of the LTV tracking MPC (``solve_tracking_mpc``) vs the JAX
package and the SLSQP oracle.

The inputs are the seeded curving references that
``scripts/export_torch_ckpt.py --tracking_golden`` stores (numpy draws),
fed to both packages. On the CPU the port's sweeps are the ADMM op's plain
version (``ops/admm.py:admm_solve_reference``), one call per solve; the CUDA
kernel is held against it on the card by ``chip_smoke.py``.

- f64 to 1e-10, ``converged`` equal.
- f32 to the tolerances of ``tests/test_torch_goal_mpc.py`` (speed and
  steer 1e-5, the control plan 2.5e-4: two f32 ADMM paths differ by their
  products' summation order over the sweeps), ``converged`` equal.
- Against SLSQP on the rows and thresholds of
  ``tests/test_goal_mpc.py::test_tracking_mpc_matches_slsqp_oracle``
  (objective gap 1e-8 relative, first controls 1e-3), and the reduction to
  the goal family at phi = 0 (1e-5) of
  ``test_tracking_mpc_reduces_to_goal_mpc_at_phi0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from irbfn_tpu.solvers import goal_mpc as J
from irbfn_tpu_torch.solvers import goal_mpc as P
from test_goal_mpc import _ltv_qp

torch.set_num_threads(1)
GOLDEN = "irbfn_tpu_torch/assets/tracking_golden.npz"
TOL64 = dict(rtol=1e-10, atol=1e-10)
TOL32 = {"speed": 1e-5, "steer": 1e-5, "controls": 2.5e-4, "r_prim": 5e-5}
N_ROWS = 48


@pytest.fixture(scope="module")
def rows():
    with np.load(GOLDEN) as z:
        return {k: z[k][:N_ROWS] for k in ("x0", "ref", "pp")}


def _port(rows, dtype):
    return P.solve_tracking_mpc(*(torch.as_tensor(rows[k], dtype=dtype)
                                  for k in ("x0", "ref", "pp")))


def test_torch_tracking_mpc_f64_matches_jax(rows):
    sj = J.solve_tracking_mpc(*(jnp.asarray(rows[k])
                                for k in ("x0", "ref", "pp")))
    st = _port(rows, torch.float64)
    for name in ("speed", "steer", "controls", "r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), **TOL64,
                                   err_msg=name)
    np.testing.assert_array_equal(st.converged.numpy(),
                                  np.asarray(sj.converged))


def test_torch_tracking_mpc_f32_matches_jax(rows):
    with jax.enable_x64(False):
        sj = J.solve_tracking_mpc(*(jnp.asarray(rows[k], jnp.float32)
                                    for k in ("x0", "ref", "pp")))
        sj = {k: np.asarray(v) for k, v in sj._asdict().items()}
    st = _port(rows, torch.float32)
    assert st.controls.dtype == torch.float32
    for name, tol in TOL32.items():
        np.testing.assert_allclose(getattr(st, name).numpy(), sj[name],
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_array_equal(st.converged.numpy(), sj["converged"])


def test_torch_tracking_mpc_batch_axes_and_one_admm_call(rows, monkeypatch):
    """Leading axes (4, 12) give the flat batch's rows, through one call
    of the ADMM op (one kernel launch on the card)."""
    calls = []
    real = P.admm_solve

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(P, "admm_solve", counting)
    flat = _port(rows, torch.float64)
    shaped = P.solve_tracking_mpc(*(torch.as_tensor(
        rows[k].reshape((4, 12) + rows[k].shape[1:]))
        for k in ("x0", "ref", "pp")))
    assert calls == [(N_ROWS, 1, 16)] * 2
    assert shaped.controls.shape == (4, 12, 8, 2)
    np.testing.assert_allclose(shaped.controls.reshape(N_ROWS, 8, 2).numpy(),
                               flat.controls.numpy(), **TOL64)


def test_torch_tracking_mpc_matches_slsqp_oracle():
    """The JAX test's 12 seeded rows and thresholds, through the port."""
    cfg = J.GoalMPCConfig()
    rng = np.random.default_rng(4)
    T = cfg.horizon
    checked = 0
    for i in range(12):
        v0 = rng.uniform(0.5, 6.0)
        x0 = np.array([0.0, 0.0, v0, rng.uniform(-0.4, 0.4)])
        phis = x0[3] + np.cumsum(rng.uniform(-0.15, 0.15, T))
        vs = np.clip(v0 + np.cumsum(rng.uniform(-0.3, 0.3, T)), 0.2, 8.0)
        pp = np.zeros((T, 4))
        pp[:, 2], pp[:, 3] = vs, phis
        ref = np.zeros((T + 1, 4))
        ref[:, 0] = np.cumsum(np.r_[0.0, vs * cfg.dt * np.cos(phis)])
        ref[:, 1] = np.cumsum(np.r_[0.0, vs * cfg.dt * np.sin(phis)])
        ref[:, 2] = np.r_[v0, vs]
        ref[:, 3] = np.r_[x0[3], phis]

        Pm, q, A, lo, hi = _ltv_qp(x0, ref, pp)
        res = minimize(lambda u: 0.5 * u @ Pm @ u + q @ u, np.zeros(16),
                       jac=lambda u: Pm @ u + q, method="SLSQP",
                       constraints=[
                           {"type": "ineq", "fun": lambda u: A @ u - lo,
                            "jac": lambda u: A},
                           {"type": "ineq", "fun": lambda u: hi - A @ u,
                            "jac": lambda u: -A}],
                       options={"maxiter": 400, "ftol": 1e-12})
        if not res.success:
            continue
        sol = P.solve_tracking_mpc(torch.as_tensor(x0[None]),
                                   torch.as_tensor(ref[None]),
                                   torch.as_tensor(pp[None]), iters=1200)
        u = sol.controls[0].numpy().reshape(-1)
        f = 0.5 * u @ Pm @ u + q @ u
        assert (f - res.fun) / max(abs(res.fun), 1.0) < 1e-8, (i, f, res.fun)
        np.testing.assert_allclose(u[:2], res.x[:2], atol=1e-3)
        assert bool(sol.converged[0])
        checked += 1
    assert checked >= 9, f"only {checked} oracle rows solved"


def test_torch_tracking_mpc_reduces_to_goal_mpc_at_phi0():
    v, T = 3.0, P.GoalMPCConfig().horizon
    goal = np.array([1.5, 1.0, 3.5, 0.4])
    x0 = np.array([0.0, 0.0, v, 0.0])
    pp = np.zeros((T, 4))
    pp[:, 2] = v
    ref = np.tile(goal, (T + 1, 1))
    sol_t = P.solve_tracking_mpc(torch.as_tensor(x0[None]),
                                 torch.as_tensor(ref[None]),
                                 torch.as_tensor(pp[None]), iters=1200)
    sol_g = P.solve_goal_family(v, torch.as_tensor(goal[None]), iters=1200)
    np.testing.assert_allclose(float(sol_t.speed[0]), float(sol_g.speed[0]),
                               atol=1e-5)
    np.testing.assert_allclose(float(sol_t.steer[0]), float(sol_g.steer[0]),
                               atol=1e-5)
