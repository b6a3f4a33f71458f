"""PyTorch port of the goal-MPC solver, the ADMM op and the lattice
generator vs the JAX package.

Inputs are numpy draws from a seed, fed to both packages. On the CPU the
port's ADMM is its plain version (``ops/admm.py:admm_solve_reference``);
the CUDA kernel is held against it on the card by ``chip_smoke.py``.

- f64: the condensed family to 1e-12, the family and row solves to 1e-10.
- f32: the tolerances of ``tests/test_goal_mpc.py::
  test_pallas_admm_matches_xla_loop`` (speed and steer 1e-5, r_prim 5e-5,
  converged identical), except the full control plan: two f32 ADMM paths
  differ there by their matmuls' summation order, grown over 300 sweeps.
  Measured on these rows, each of JAX's XLA loop, JAX's Pallas kernel and
  the port is 1.1-1.2e-4 from the f64 solution, and the port 1.1-1.2e-4
  from either JAX path, so plans agree to 2.5e-4, and the port must stay
  as close to f64 as JAX's own f32 loop is.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.parallel import GridSpec as JGridSpec
from irbfn_tpu.parallel import build_lattice as jbuild_lattice
from irbfn_tpu.solvers import goal_mpc as J
from irbfn_tpu_torch import _device
from irbfn_tpu_torch.ops import admm
from irbfn_tpu_torch.parallel import GridSpec, build_lattice, solve_lattice
from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen
from irbfn_tpu_torch.sim import oval_track
from irbfn_tpu_torch.solvers import goal_mpc as P

torch.set_num_threads(1)
CFG = P.GoalMPCConfig()
TOL64 = dict(rtol=1e-10, atol=1e-10)
# f32 plans: two f32 paths each ~1.2e-4 from f64 (module docstring)
TOL_PLAN32 = 2.5e-4


def _goals(rng, G):
    """Lattice-range goals in solver order (x, y, v, t)."""
    return np.stack([rng.uniform(-1.2, 4.0, G), rng.uniform(0.0, 4.0, G),
                     rng.uniform(-1.0, 8.0, G),
                     rng.uniform(-3.14, 3.14, G)], axis=1)


def _rows(v_car, goals):
    """Reference-ABI rows (v_car, x, y, t, v) from solver-order goals."""
    return np.concatenate([np.broadcast_to(v_car, goals.shape[:1])[:, None],
                           goals[:, :2], goals[:, 3:4], goals[:, 2:3]],
                          axis=1)


def _np(sol):
    return {k: np.asarray(v) for k, v in sol._asdict().items()}


@pytest.mark.parametrize("v", [-1.0, 0.0, 2.5, 7.3, 8.0])
def test_torch_condensed_family_f64(v):
    fj = J.condensed_family(jnp.asarray(v, jnp.float64), J.GoalMPCConfig(),
                            dtype=jnp.float64)
    ft = P.condensed_family(v, CFG, torch.float64, device="cpu")
    fb = P.condensed_family(torch.tensor([0.7, v, -0.4],
                                         dtype=torch.float64),
                            CFG, torch.float64, device="cpu")
    for name, a, b, c in zip(fj._fields, fj, ft, fb):
        assert b.dtype == torch.float64 and c.shape == (3,) + b.shape
        scale = max(1.0, float(np.abs(np.asarray(a)).max()))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0.0,
                                   atol=1e-12 * scale, err_msg=name)
        np.testing.assert_allclose(c[1].numpy(), np.asarray(a), rtol=0.0,
                                   atol=1e-12 * scale, err_msg=name)


def test_torch_solve_goal_family_f64():
    goals = _goals(np.random.default_rng(2), 32)
    sj = _np(J.solve_goal_family(jnp.asarray(4.5, jnp.float64),
                                 jnp.asarray(goals), iters=400))
    st = P.solve_goal_family(4.5, goals, iters=400, device="cpu")
    for k, v in st._asdict().items():
        assert v.device.type == "cpu"
        np.testing.assert_allclose(v.numpy(), sj[k], err_msg=k, **TOL64)


def test_torch_solve_goal_family_f32_matches_xla_and_pallas():
    goals = _goals(np.random.default_rng(7), 96).astype(np.float32)
    with jax.enable_x64(False):
        v = jnp.asarray(4.5, jnp.float32)
        ref = _np(J.solve_goal_family(v, jnp.asarray(goals), iters=300))
        pal = _np(J.solve_goal_family_pallas(v, jnp.asarray(goals), iters=300,
                                             tile_g=32, interpret=True))
    s64 = _np(J.solve_goal_family(jnp.asarray(4.5, jnp.float64),
                                  jnp.asarray(goals, jnp.float64), iters=300))
    st = _np(P.solve_goal_family(4.5, goals, iters=300, device="cpu"))
    assert st["speed"].dtype == np.float32
    for other in (ref, pal):
        np.testing.assert_allclose(st["speed"], other["speed"], atol=1e-5)
        np.testing.assert_allclose(st["steer"], other["steer"], atol=1e-5)
        np.testing.assert_allclose(st["controls"], other["controls"],
                                   atol=TOL_PLAN32)
        np.testing.assert_allclose(st["r_prim"], other["r_prim"], atol=5e-5)
        assert (st["converged"] == other["converged"]).all()
    err = {name: np.abs(s["controls"] - s64["controls"]).max()
           for name, s in (("port", st), ("xla", ref))}
    assert err["port"] <= 1.5 * err["xla"], err


def test_torch_solve_goal_mpc_rows():
    rng = np.random.default_rng(3)
    rows = _rows(rng.uniform(-1.0, 8.0, 24), _goals(rng, 24))
    sj = _np(J.solve_goal_mpc(jnp.asarray(rows), iters=300))
    st = P.solve_goal_mpc(rows, iters=300, device="cpu")
    for k, v in st._asdict().items():
        np.testing.assert_allclose(v.numpy(), sj[k], err_msg=k, **TOL64)
    # one v_car: the family path and the row path are the same solve
    goals = _goals(rng, 32)
    fam = P.solve_goal_family(4.5, goals, iters=400, device="cpu")
    row = P.solve_goal_mpc(_rows(4.5, goals), iters=400, device="cpu")
    np.testing.assert_allclose(fam.speed.numpy(), row.speed.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(fam.steer.numpy(), row.steer.numpy(),
                               atol=1e-10)


def test_torch_goal_mpc_constraints_respected():
    """Aggressive goals: every constraint row holds at the ADMM solution
    (tests/test_goal_mpc.py::test_goal_mpc_constraints_respected)."""
    rng = np.random.default_rng(1)
    v_car = rng.uniform(-1.0, 8.0, 64)
    sol = P.solve_goal_mpc(_rows(v_car, _goals(rng, 64)), iters=1200,
                           device="cpu")
    u = sol.controls.numpy()
    tol = 5e-3
    assert np.all(np.abs(u[:, :, 0]) <= CFG.max_accel + tol)
    assert np.all(np.abs(u[:, :, 1]) <= CFG.max_steer + tol)
    assert np.all(np.abs(np.diff(u[:, :, 1], axis=1))
                  <= CFG.max_dsteer * CFG.dt + tol)
    v_traj = v_car[:, None] + CFG.dt * np.cumsum(u[:, :, 0], axis=1)
    assert np.all(v_traj <= CFG.max_speed + tol)
    assert np.all(v_traj >= CFG.min_speed - tol)


def test_torch_goal_mpc_reference_abi_semantics():
    """speed = v_car + a_0 dt and steer = delta_0; a goal dead ahead at the
    current speed steers ~0 at ~v_car, a faster goal accelerates, a goal to
    the left steers left."""
    v = 3.0
    ahead = np.array([[v, v * CFG.dt * CFG.horizon, 0.0, 0.0, v]])
    sol = P.solve_goal_mpc(ahead, iters=600, device="cpu")
    np.testing.assert_allclose(float(sol.steer[0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(sol.speed[0]), v, atol=0.05)
    np.testing.assert_allclose(
        float(sol.speed[0]), v + float(sol.controls[0, 0, 0]) * CFG.dt,
        rtol=1e-12)
    faster = np.array([[1.0, 3.0, 0.0, 0.0, 6.0]])
    assert float(P.solve_goal_mpc(faster, iters=600,
                                  device="cpu").speed[0]) > 1.0
    left = np.array([[3.0, 1.0, 2.0, 0.5, 3.0]])
    assert float(P.solve_goal_mpc(left, iters=600,
                                  device="cpu").steer[0]) > 0.01


def test_torch_admm_ragged_and_empty_families():
    """The plain ADMM over several families equals one family at a time,
    and an empty goal block gives empty outputs."""
    rng = np.random.default_rng(4)
    v = torch.tensor([-1.0, 3.0, 8.0], dtype=torch.float64)
    goals = torch.from_numpy(_goals(rng, 15).reshape(3, 5, 4))
    fam, rho, kinv, q = P._family_operands(v, goals, CFG, 1e-6)
    ops = (q, fam.A_con, kinv, fam.lo, fam.hi, rho)
    x, rp, rd = admm.admm_solve(*ops, iters=200)
    for f in range(3):
        xf, rpf, rdf = admm.admm_solve(*(t[f:f + 1] for t in ops), iters=200)
        np.testing.assert_allclose(x[f:f + 1].numpy(), xf.numpy(), **TOL64)
        np.testing.assert_allclose(rp[f:f + 1].numpy(), rpf.numpy(), **TOL64)
        np.testing.assert_allclose(rd[f:f + 1].numpy(), rdf.numpy(), **TOL64)
    x0, rp0, _ = admm.admm_solve(q[:, :0], *ops[1:], iters=5)
    assert x0.shape == (3, 0, 16) and rp0.shape == (3, 0)


def test_torch_admm_dispatch_has_no_fallback():
    """A CUDA request without a card raises (torch's own error), another
    device raises, and the kernel wrapper refuses what the kernel does not
    take before it reaches the card."""
    goals = _goals(np.random.default_rng(5), 4)
    with pytest.raises((AssertionError, RuntimeError)):
        P.solve_goal_family(2.0, goals)  # device None: the card
    with pytest.raises((AssertionError, RuntimeError)):
        P.solve_goal_family(2.0, goals, device="cuda")
    v = torch.tensor([2.0])
    fam, rho, kinv, q = P._family_operands(
        v, torch.from_numpy(goals[None].astype(np.float32)), CFG, 1e-6)
    ops = (q, fam.A_con, kinv, fam.lo, fam.hi, rho)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        admm.admm_solve(*(t.to("meta") for t in ops))
    with pytest.raises(ValueError, match="f32"):
        admm._launch(*(t.double() for t in ops), 10, 1e-6, 1.6)
    cfg4 = CFG._replace(horizon=4)
    fam, rho, kinv, q = P._family_operands(
        v, torch.from_numpy(goals[None].astype(np.float32)), cfg4, 1e-6)
    with pytest.raises(ValueError, match="horizons"):
        admm._launch(*(t.contiguous() for t in (q, fam.A_con, kinv, fam.lo,
                                                fam.hi, rho)), 10, 1e-6, 1.6)


@pytest.mark.parametrize("F,G,variant", [
    (1, 2_642_368, "family"),  # one lattice family in one launch
    (1, 262_144, "family"),  # the table generator's chunk
    (1, 1, "lane"), (1000, 1, "lane"),  # the planner: one goal per lane
    (19, 1000, "lane"), (3, 33, "lane"),
    (1, 40_959, "lane"), (1, 40_960, "family"),  # the least total
    (1000, 256, "family"), (1000, 160, "family"),
    (1000, 159, "lane"), (4000, 64, "lane"),  # blocks mostly empty
    (19, 2560, "family"),
])
def test_torch_admm_variant_rule(F, G, variant):
    """Which kernel variant serves (F, G): the family variant from 40,960
    rows in all, with each family's 256-row blocks at least 5/8 full; the
    lane variant (a warp per row, any shape) otherwise."""
    assert admm.admm_variant(F, G) == variant
    assert variant in admm.VARIANTS


def test_torch_admm_launch_checks_raise():
    """Shape and alignment checks of the kernel wrapper, before the card."""
    goals = _goals(np.random.default_rng(8), 4).astype(np.float32)
    fam, rho, kinv, q = P._family_operands(
        torch.tensor([2.0]), torch.from_numpy(goals[None]), CFG, 1e-6)
    ops = [t.contiguous() for t in (q, fam.A_con, kinv, fam.lo, fam.hi, rho)]
    with pytest.raises(ValueError, match="contiguous"):
        admm._launch(ops[0].transpose(1, 2).contiguous().transpose(1, 2),
                     *ops[1:], 10, 1e-6, 1.6)
    with pytest.raises(ValueError, match="do not agree"):
        admm._launch(*ops[:3], ops[3][:, :30].contiguous(), *ops[4:], 10,
                     1e-6, 1.6)
    with pytest.raises(ValueError, match="do not agree"):
        admm._launch(*ops[:5], torch.ones(2), 10, 1e-6, 1.6)
    flat = torch.zeros(ops[0].numel() + 1)
    off = flat[1:].view(ops[0].shape).copy_(ops[0])
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        admm._launch(off, *ops[1:], 10, 1e-6, 1.6)
    big = [t.expand((70000,) + t.shape[1:]) for t in ops]
    assert admm.admm_variant(70000, 1) == "lane"  # no family limit applies
    with pytest.raises(ValueError, match="contiguous"):
        admm._launch(*big, 10, 1e-6, 1.6)


def test_torch_default_device_is_the_card():
    assert _device.resolve_device(None) == torch.device("cuda")
    assert _device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        oval_track(30.0, 15.0, n_samples=64)  # no GPU here: torch raises


def test_torch_build_lattice_row_order():
    axes = [("a", -1.0, 1.0, 3), ("b", 0.0, 2.0, 2), ("c", 5.0, 5.5, 4)]
    got = build_lattice([GridSpec(*g) for g in axes])
    ref = jbuild_lattice([JGridSpec(*g) for g in axes])
    assert got.dtype == np.float32 and got.shape == (24, 3)
    np.testing.assert_array_equal(got, ref)
    # 'ij' order: the last axis is the fastest
    np.testing.assert_array_equal(got[:4, 2],
                                  np.linspace(5.0, 5.5, 4).astype(np.float32))


def test_torch_solve_lattice_chunks_equal_one_solve():
    goals = _goals(np.random.default_rng(6), 23).astype(np.float32)

    def fn(g, v):
        sol = P.solve_goal_family(v, g, iters=150)
        return {"speed": sol.speed, "converged": sol.converged}

    out = solve_lattice(fn, goals, batch_per_device=7, args=(3.5,),
                        device="cpu")
    direct = P.solve_goal_family(3.5, goals, iters=150, device="cpu")
    assert out["speed"].shape == (23,) and out["converged"].dtype == bool
    np.testing.assert_array_equal(out["speed"], direct.speed.numpy())
    np.testing.assert_array_equal(out["converged"],
                                  direct.converged.numpy())
    lat = P.solve_goal_lattice(3.5, goals, iters=150, batch_per_device=10,
                               device="cpu")
    np.testing.assert_array_equal(lat["steer"], direct.steer.numpy())


TINY_GRID = ["--v_car_min", "0.0", "--v_car_max", "7.5", "--d_v_car", "7.5",
             "--x_goal_min", "0.5", "--x_goal_max", "1.5", "--d_x_goal", "1.0",
             "--y_goal_min", "0.0", "--y_goal_max", "2.0", "--d_y_goal", "2.0",
             "--t_goal_min", "-3.0", "--t_goal_max", "0.0", "--d_t_goal",
             "3.0", "--v_goal_min", "-1.0", "--v_goal_max", "8.0",
             "--d_v_goal", "9.0", "--iters", "100"]


def test_torch_goal_table_npz_matches_reference_layout(tmp_path,
                                                       monkeypatch):
    """The generator's npz on a tiny grid against the JAX script's: the same
    arrays, dtypes and metadata, the same -999 rows."""
    ref_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.setattr(sys, "argv", ["gen_goal_mpc_table.py", *TINY_GRID,
                                      "--save_path", str(ref_dir)])
    with jax.enable_x64(False):
        runpy.run_path(os.path.join("scripts", "gen_goal_mpc_table.py"),
                       run_name="__main__")
    out = gen.main([*TINY_GRID, "--save_path", str(port_dir),
                    "--device", "cpu"])
    (ref_file,) = os.listdir(ref_dir)
    assert os.path.basename(out) == ref_file == "goal_mpc_table_2x2x2x2x2.npz"
    with np.load(ref_dir / ref_file) as r, np.load(out) as p:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape, k
        for k in ("inputs", "valid", "lows", "highs", "nums", "dims"):
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
        valid = r["valid"]
        assert 0 < valid.sum() < valid.size  # both kinds of rows occur
        np.testing.assert_array_equal(p["outputs"][~valid], -999.0)
        np.testing.assert_allclose(p["outputs"][valid], r["outputs"][valid],
                                   rtol=0.0, atol=1e-5)
