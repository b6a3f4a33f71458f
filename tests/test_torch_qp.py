"""PyTorch port of the batched ADMM QP solvers, the condensed linear MPC and
the quadrotor pipeline vs the JAX package.

Inputs are numpy draws from a seed, fed to both packages.

- f64: ``solve_qp_batch`` (per-problem Cholesky) and ``_solve_box_qp_shared``
  with an f64 P to 1e-10, with ``iterations`` and ``converged`` equal; the
  condensation to 1e-12.
- The linear MPC builds its shared P and KKT inverse in f32 in both
  packages (so does the JAX package under x64), and the two f32 inverses
  differ in the last place (LAPACK against XLA). So with an f32 or an f64
  state the controls agree to the solver's own tolerance (1e-4),
  ``converged`` exactly and a row's sweep count within one (its residual
  crosses ``tol`` a sweep apart).
- The quadrotor pipeline at a cut size (``--n_grid 3 --n_extra 512
  --num_k 16``) against the JAX script's own run of that size, stored by
  ``scripts/export_torch_ckpt.py --quadrotor_golden``: the same table to
  the solver's tolerance, the fit's L1 and the off-grid MAE within 1e-3
  relative; the committed ``quadrotor_pr`` forward against JAX in f64 and
  f32, and its 80-step regulation loops against the golden's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.solvers import qp as J
from irbfn_tpu.train import load_model as jload_model
from irbfn_tpu_torch.solvers import qp as P
from irbfn_tpu_torch.train import load_model
from irbfn_tpu_torch.train import quadrotor_pipeline as Q

torch.set_num_threads(1)
ASSET = "irbfn_tpu_torch/assets/quadrotor_pr"
TOL64 = dict(rtol=1e-10, atol=1e-10)
TOL_MPC32 = 1e-4  # the solver's residual tolerance
# an f32 forward of the committed net: the per-region heads' sum |w| is
# 7.1e4 and 1.5e5 per output (the flagship's regime), so two f32 summation
# orders differ by ~2e-3 (measured: 1.6e-3; each is 2.3e-3 from f64)
TOL_FORWARD32 = 5e-3
TOL_RING_NET = 1e-3  # 80 closed-loop steps of those forwards
TOL_RING_MPC = 1e-4  # re-solves converged to 1e-4
TOL_CUT = 1e-3  # relative, L1 and off-grid MAE of the cut run
TOL_CUT_SETTLE_LANES = 3  # of 64: rollouts that end within ~1 mm of 0.1 m


def _qps(rng, B, n, m):
    Ms = rng.normal(size=(B, n, n))
    P_ = np.einsum("bij,bkj->bik", Ms, Ms) + 0.5 * np.eye(n)
    return (P_, rng.normal(size=(B, n)), rng.normal(size=(B, m, n)),
            -rng.uniform(0.1, 1.0, (B, m)), rng.uniform(0.1, 1.0, (B, m)))


def _assert_solutions(sj, st, tol=TOL64):
    for name in ("x", "primal_residual", "dual_residual"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), **tol,
                                   err_msg=name)
    np.testing.assert_array_equal(st.iterations.numpy(),
                                  np.asarray(sj.iterations))
    np.testing.assert_array_equal(st.converged.numpy(),
                                  np.asarray(sj.converged))


@pytest.mark.parametrize("rho", [None, 0.7])
def test_torch_solve_qp_batch_f64_matches_jax(rho):
    ops = _qps(np.random.default_rng(1), 32, 6, 9)
    sj = J.solve_qp_batch(*(jnp.asarray(a) for a in ops), rho=rho,
                          iters=500)
    st = P.solve_qp_batch(*(torch.as_tensor(a) for a in ops), rho=rho,
                          iters=500)
    # both stopping rules occur: rows that converge, rows cut at iters
    assert 0 < int(np.asarray(sj.converged).sum()) <= 32
    _assert_solutions(sj, st)


def test_torch_solve_qp_batch_batch_shapes():
    """An unbatched problem and a (2, 3) batch, as the JAX function takes
    them."""
    ops = _qps(np.random.default_rng(2), 6, 4, 4)
    one = [a[0] for a in ops]
    _assert_solutions(J.solve_qp_batch(*(jnp.asarray(a) for a in one)),
                      P.solve_qp_batch(*(torch.as_tensor(a) for a in one)))
    two = [a.reshape((2, 3) + a.shape[1:]) for a in ops]
    sj = J.solve_qp_batch(*(jnp.asarray(a) for a in two), iters=300)
    st = P.solve_qp_batch(*(torch.as_tensor(a) for a in two), iters=300)
    assert st.x.shape == (2, 3, 4) and st.iterations.shape == (2, 3)
    _assert_solutions(sj, st)


def test_torch_qp_active_box():
    """min 0.5 x^2 - 10 x s.t. x <= 2 -> x* = 2 (the JAX test's case)."""
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    sol = P.solve_qp_batch(t([[1.0]]), t([-10.0]), t([[1.0]]), t([-5.0]),
                           t([2.0]))
    np.testing.assert_allclose(sol.x.numpy(), [2.0], atol=1e-6)


def test_torch_box_qp_shared_f64_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(12, 12))
    P_ = M @ M.T + np.eye(12)
    q = rng.normal(size=(64, 12)) * 5.0
    lo, hi = np.full((64, 12), -0.4), np.full((64, 12), 0.6)
    args = (P_, q, lo, hi)
    sj = J._solve_box_qp_shared(*(jnp.asarray(a) for a in args), rho=2.0,
                                iters=400)
    st = P._solve_box_qp_shared(*(torch.as_tensor(a) for a in args),
                                rho=2.0, iters=400)
    assert 0 < int(np.asarray(sj.converged).sum())
    _assert_solutions(sj, st)


def test_torch_condense_matches_jax():
    mj = J.double_integrator_mpc(dt=0.1, horizon=7)
    mt = P.double_integrator_mpc(dt=0.1, horizon=7, device="cpu")
    for name in ("Ad", "Bd", "Q", "Qf", "R", "u_lo", "u_hi"):
        np.testing.assert_array_equal(
            getattr(mt, name).numpy(),
            np.asarray(getattr(mj, name), np.float32), err_msg=name)
    for a, b in zip(J.condense(mj), P.condense(mt)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def _states(seed, B):
    return np.random.default_rng(seed).uniform(
        [-3, -3, -2, -2], [3, 3, 2, 2], (B, 4)).astype(np.float32)


def test_torch_linear_mpc_f32_matches_jax():
    x0 = _states(0, 256)
    with jax.enable_x64(False):
        cj, sj = J.solve_linear_mpc_batch(
            J.double_integrator_mpc(), jnp.asarray(x0),
            jnp.zeros((256, 4), jnp.float32))
        cj, it_j, conv_j = (np.asarray(a) for a in (cj, sj.iterations,
                                                    sj.converged))
    ct, st = P.solve_linear_mpc_batch(P.double_integrator_mpc(device="cpu"),
                                      torch.as_tensor(x0),
                                      torch.zeros(256, 4))
    assert ct.shape == (256, 10, 2) and ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=TOL_MPC32)
    np.testing.assert_array_equal(st.converged.numpy(), conv_j)
    assert np.abs(st.iterations.numpy() - it_j).max() <= 1


def test_torch_linear_mpc_f64_state_matches_jax():
    """An f64 state with the f32 problem matrices, as JAX under x64; a goal
    away from the origin exercises g_rep."""
    x0 = _states(1, 64).astype(np.float64)
    goal = np.tile([1.0, -0.5, 0.0, 0.0], (64, 1))
    mj = J.double_integrator_mpc(dt=0.1, horizon=20, u_max=5.0)
    cj, sj = J.solve_linear_mpc_batch(mj, jnp.asarray(x0), jnp.asarray(goal),
                                      iters=800)
    mt = P.double_integrator_mpc(dt=0.1, horizon=20, u_max=5.0,
                                 device="cpu")
    ct, st = P.solve_linear_mpc_batch(mt, torch.as_tensor(x0),
                                      torch.as_tensor(goal), iters=800)
    assert ct.dtype == torch.float64
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=TOL_MPC32)
    np.testing.assert_array_equal(st.converged.numpy(),
                                  np.asarray(sj.converged))
    assert np.abs(st.iterations.numpy()
                  - np.asarray(sj.iterations)).max() <= 1


@pytest.fixture(scope="module")
def golden():
    with np.load(ASSET + "_golden.npz") as z:
        return {k: z[k] for k in z.files}


def test_torch_quadrotor_cut_run_matches_jax_script(golden, tmp_path):
    args = Q.parse_args(["--n_grid", "3", "--n_extra", "512", "--num_k",
                         "16", "--save_path", str(tmp_path), "--out_dir",
                         str(tmp_path), "--device", "cpu"])
    out = Q.run(args, "cpu")
    res = out["results"]
    with np.load(tmp_path / "quadrotor_table.npz") as z:
        np.testing.assert_array_equal(z["inputs"], golden["cut_inputs"])
        np.testing.assert_allclose(z["outputs"], golden["cut_controls"],
                                   rtol=0, atol=TOL_MPC32)
    for k in ("train_l1", "off_grid_mae"):
        np.testing.assert_allclose(res[k], golden[f"cut_{k}"], rtol=TOL_CUT,
                                   err_msg=k)
    n = out["starts"].shape[0]
    assert res["settle_frac_mpc"] == golden["cut_settle_frac_mpc"] == 1.0
    assert (abs(res["settle_frac_net"] - golden["cut_settle_frac_net"]) * n
            <= TOL_CUT_SETTLE_LANES)
    np.testing.assert_allclose(res["final_dist_net"],
                               golden["cut_final_dist_net"], rtol=1e-2)
    with open(tmp_path / "quadrotor_results.json") as f:
        assert json.load(f) == res
    # the checkpoint reloads to the same net
    model, _ = load_model(out["config_path"], out["ckpt_dir"], device="cpu")
    x = torch.as_tensor(out["starts"])
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(),
                                      out["model"](x).numpy())


def test_torch_quadrotor_pr_forward_matches_jax(golden):
    x = golden["off_x"][:512]
    m64, _ = load_model(ASSET + ".json", ASSET + ".npz", device="cpu",
                        dtype=torch.float64)
    with torch.no_grad():
        f64 = m64(torch.as_tensor(x, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(f64, golden["off_forward_f64"][:512],
                               **TOL64)
    model, variables, _ = jload_model("configs/quadrotor_pr.yaml",
                                      "ckpts/quadrotor_pr")
    with jax.enable_x64(False):
        v32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           {"params": variables["params"]})
        fj = np.asarray(model.apply(v32, jnp.asarray(x)))
    m32, _ = load_model(ASSET + ".json", ASSET + ".npz", device="cpu")
    with torch.no_grad():
        f32 = m32(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(f32, fj, rtol=0, atol=TOL_FORWARD32)


def test_torch_quadrotor_regulation_matches_jax(golden):
    model, _ = load_model(ASSET + ".json", ASSET + ".npz", device="cpu")
    mpc = P.double_integrator_mpc(device="cpu")
    s = torch.as_tensor(golden["ring_starts"][:16])
    tr_net = Q.roll_net(model.eval(), mpc, s).numpy()
    tr_mpc = Q.roll_mpc(mpc, s).numpy()
    assert tr_net.shape == (80, 16, 4)
    np.testing.assert_allclose(tr_net, golden["ring_net_f32"][:, :16],
                               rtol=0, atol=TOL_RING_NET)
    np.testing.assert_allclose(tr_mpc, golden["ring_mpc_f32"][:, :16],
                               rtol=0, atol=TOL_RING_MPC)
    assert Q.regulation(tr_net, tr_mpc) == pytest.approx(Q.regulation(
        golden["ring_net_f32"][:, :16], golden["ring_mpc_f32"][:, :16]),
        abs=1e-3)
