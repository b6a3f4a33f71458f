"""The port's tiered Frenet table generator, the tables both packages write,
and the slice as a whole at a small size.

- ``solve_table`` on a 2^8-row grid, f64 on the CPU with small budgets:
  flagged rows are re-solved and merged, certified rows are never touched,
  the file name and keys are the reference's;
- the table is the state carried across the packages: an npz written by
  either package's functions loads in the other's trainer loader and
  explicit planner;
- table (port, 2^8 rows) -> ``train_frenet --direct_fit --fit_mode
  per_region --num_k 24`` -> ``eval_offline`` (its control L1 equals the
  fit's own) -> 4 lanes x 60 steps of ``IRBFNFrenetPlanner``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.parallel import datagen as jdatagen
from irbfn_tpu.planning import explicit as je
from irbfn_tpu.solvers import nmpc as J
from irbfn_tpu_torch.parallel import datagen
from irbfn_tpu_torch.parallel import gen_nmpc_table_frenet as gen
from irbfn_tpu_torch.planning import explicit as te
from irbfn_tpu_torch.solvers import nmpc as T
from irbfn_tpu_torch.train import train_frenet as tf

torch.set_num_threads(1)
GRID_ARGS = ["--num_ey", "2", "--num_delta", "2", "--num_vx_car", "2",
             "--num_vy_car", "2", "--num_vx_goal", "2", "--num_wz", "2",
             "--num_epsi", "2", "--num_curv", "2"]
SMALL = T.NMPCConfig(gn_iters=8, al_outer=2)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """The 2^8-row table at small budgets: the tiered pipeline's results,
    recorded pass by pass, and the npz ``main`` would write."""
    out_dir = tmp_path_factory.mktemp("table")
    args = gen.parse_args(GRID_ARGS + [
        "--device", "cpu", "--dtype", "f64", "--save_path", str(out_dir),
        "--batch_per_device", "100", "--phase1_iters", "3",
        "--resolve_factor", "2", "--run_tag", "_t"])
    calls = []
    real = gen.solve_lattice_point

    def recording(rows, params, cfg):
        sol = real(rows, params, cfg)
        calls.append((cfg, rows.cpu().numpy().copy(), sol))
        return sol

    gen.solve_lattice_point = recording
    try:
        results = gen.solve_table(args, cfg=SMALL)
    finally:
        gen.solve_lattice_point = real
    res = results[0]
    path = gen.table_name(args, res["grid"], res["mu"])
    datagen.save_table(path, datagen.frenet_table(res["rows"], res["sol"]))
    return args, res, calls, path


def test_tiered_passes_resolve_only_flagged_rows(table):
    args, res, calls, _ = table
    rows = res["rows"]
    assert rows.shape == (256, 8) and rows.dtype == np.float64
    by_pass = {}
    for cfg, r, sol in calls:
        by_pass.setdefault((cfg.gn_iters, cfg.al_outer), []).append((r, sol))
    # cheap pass: every row, in chunks of 100, at the 3-iteration cap
    cheap = by_pass[(3, SMALL.al_outer)]
    assert [len(r) for r, _ in cheap] == [100, 100, 56]
    np.testing.assert_array_equal(np.concatenate([r for r, _ in cheap]), rows)
    feas1 = np.concatenate([s.feasible.numpy() for _, s in cheap])
    assert res["certified_cheap"] == pytest.approx(feas1.mean())
    assert 0.0 < feas1.mean() < 1.0
    # full pass: exactly the rows the cheap pass flagged, in order
    full = by_pass[(SMALL.gn_iters, SMALL.al_outer)]
    np.testing.assert_array_equal(np.concatenate([r for r, _ in full]),
                                  rows[~feas1])
    feas2 = feas1.copy()
    feas2[~feas1] = np.concatenate([s.feasible.numpy() for _, s in full])
    assert res["feasible_tiered"] == pytest.approx(feas2.mean())
    # straggler pass: what is still flagged, at 2x iterations, +2 AL rounds
    hard = by_pass[(2 * SMALL.gn_iters, SMALL.al_outer + 2)]
    np.testing.assert_array_equal(np.concatenate([r for r, _ in hard]),
                                  rows[~feas2])
    assert set(by_pass) == {(3, 2), (8, 2), (16, 4)}
    np.testing.assert_array_equal(res["touched"], ~feas1)
    assert set(res["seconds"]) == {"cheap", "full", "straggler"}
    assert res["rates"]["overall"] < res["rates"]["tiered"]


def test_certified_rows_are_final_and_flagged_rows_are_merged(table):
    _, res, calls, _ = table
    sol = res["sol"]
    cheap = [s for cfg, _, s in calls if cfg.gn_iters == 3]
    accel1 = np.concatenate([s.accel.numpy() for s in cheap])
    sv1 = np.concatenate([s.steer_vel.numpy() for s in cheap])
    feas1 = np.concatenate([s.feasible.numpy() for s in cheap])
    onehot1 = np.concatenate([s.active_onehot.numpy() for s in cheap])
    keep = feas1
    np.testing.assert_array_equal(sol.accel[keep], accel1[keep])
    np.testing.assert_array_equal(sol.steer_vel[keep], sv1[keep])
    np.testing.assert_array_equal(sol.active_onehot[keep],
                                  onehot1[keep].astype(bool))
    assert sol.feasible[keep].all()
    # a row a later pass recovered carries that pass's controls
    recovered = sol.feasible & ~feas1
    assert recovered.any()
    assert not np.array_equal(sol.accel[recovered], accel1[recovered])
    later = {}
    for cfg, r, s in calls:
        if cfg.gn_iters != 3:
            for row, a, f in zip(r, s.accel.numpy(), s.feasible.numpy()):
                later[row.tobytes()] = (a, f)  # the last pass wins
    for i in np.nonzero(~feas1)[0]:
        a, f = later[res["rows"][i].tobytes()]
        np.testing.assert_array_equal(sol.accel[i], a)
        assert sol.feasible[i] == f
    assert sol.active_onehot.dtype == bool and sol.active_onehot.shape == (
        256, 86)


def test_table_file_name_and_keys_are_the_references(table):
    args, res, _, path = table
    assert os.path.basename(path) == ("frenet_table_2x2x2x2x2x2x2x2_mu1.00_"
                                      "cs5.0_t.npz")
    with np.load(path) as z:
        assert sorted(z.files) == ["constraints", "inputs", "outputs",
                                   "valid"]
        assert z["outputs"].shape == (256, 5, 2)
        assert z["constraints"].shape == (256, 86)
        assert z["constraints"].dtype == np.float64
        bad = ~z["valid"]
        assert (z["outputs"][bad] == -999.0).all()
        assert (z["constraints"][bad] == -999.0).all()
        np.testing.assert_array_equal(z["inputs"], res["rows"])
    # the row order is the reference's meshgrid order
    jrows = jdatagen.build_lattice(tuple(
        jdatagen.GridSpec(g.name, g.lo, g.hi, g.num) for g in res["grid"]),
        dtype=np.float64)
    np.testing.assert_array_equal(res["rows"], jrows)


def test_flags_defaults_and_mu_sweep_match_the_reference():
    import argparse

    from irbfn_tpu.utils import args as jargs

    jp = argparse.ArgumentParser()
    jargs.add_frenet_grid_args(jp)
    jargs.add_vehicle_args(jp)
    jargs.add_io_args(jp)
    want = vars(jp.parse_args([]))
    got = vars(gen.parse_args([]))
    assert {k: got[k] for k in want} == want
    assert (got["batch_per_device"], got["resolve_factor"],
            got["phase1_iters"], got["skip_constraints"]) == (8192, 4, 12,
                                                              False)
    assert len(gen.build_lattice(gen.grid_from_args(gen.parse_args(
        [])))) == 12 * 7 * 11 * 11 * 5 * 11 * 11 * 3
    rows = gen.wide_rows(64, 0)
    grid = gen.grid_from_args(gen.parse_args(list(gen.WIDE_RANGE_ARGS)))
    assert rows.shape == (64, 8) and all(
        g.lo <= rows[:, i].min() and rows[:, i].max() <= g.hi
        for i, g in enumerate(grid))
    assert grid[7].lo == -0.45 and grid[2].hi == 8.0 and grid[4].hi == 8.0


def test_flat_solve_mu_sweep_and_skip_constraints(tmp_path):
    """--phase1_iters 0 --resolve_factor 0 is one flat pass; the mu sweep
    solves the largest mu first and emits the arange endpoint; without the
    one-hot the table has no ``constraints``."""
    args = gen.parse_args([
        "--num_ey", "2", "--num_delta", "1", "--num_vx_car", "2",
        "--num_vy_car", "1", "--num_vx_goal", "1", "--num_wz", "1",
        "--num_epsi", "2", "--num_curv", "1", "--device", "cpu", "--dtype",
        "f64", "--phase1_iters", "0", "--resolve_factor", "0",
        "--skip_constraints", "--mu_min", "0.9", "--mu_max", "1.0",
        "--d_mu", "0.1", "--save_path", str(tmp_path)])
    cfg = dataclasses.replace(SMALL, gn_iters=4, al_outer=1)
    results = gen.solve_table(args, cfg=cfg)
    assert [round(r["mu"], 2) for r in results] == [1.1, 1.0, 0.9]
    for r in results:
        assert r["certified_cheap"] is None and not r["touched"].any()
        assert set(r["seconds"]) == {"full"}
        t = datagen.frenet_table(r["rows"], r["sol"])
        assert "constraints" not in t and t["outputs"].shape == (8, 5, 2)
    # the flat pass is the plain solver on the same rows
    want = T.solve_lattice_point(
        torch.as_tensor(results[1]["rows"]), gen.fullscale_params(
            mu=1.0, cs=5.0, dtype=torch.float64, device="cpu"), cfg)
    np.testing.assert_array_equal(results[1]["sol"].accel,
                                  want.accel.numpy())


# ---------------------------------- a table crosses the packages

def test_port_table_loads_in_the_jax_package(table):
    """The port's npz in the JAX package's explicit planner and in its
    trainer's loading lines (scripts/train_frenet.py)."""
    from irbfn_tpu.train import mirror_frenet_table

    _, res, _, path = table
    d = np.load(path)
    jt = je.grid_table_from_arrays(d["inputs"], d["outputs"], d["valid"])
    tt = te.grid_table_from_arrays(d["inputs"], d["outputs"], d["valid"],
                                   device="cpu")
    assert jt.nums == tt.nums == (2,) * 8
    np.testing.assert_array_equal(np.asarray(jt.outputs), tt.outputs.numpy())
    np.testing.assert_array_equal(np.asarray(jt.valid), res["sol"].feasible)
    q = d["inputs"][res["sol"].feasible][:16] + 1e-3
    jo, jv = je.grid_lookup_linear(jt, jnp.asarray(q))
    to, tv = te.grid_lookup_linear(tt, torch.as_tensor(q))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), atol=1e-12)
    # the trainer's loader: block layout, -999 filter, mirror
    outputs = jdatagen.controls_block(d["outputs"])
    valid = ~np.any(outputs == -999.0, axis=1)
    np.testing.assert_array_equal(valid, d["valid"])
    tin, tout, tvalid = tf.load_table(path)
    np.testing.assert_array_equal(tout, outputs)
    np.testing.assert_array_equal(tvalid, valid)
    jm = mirror_frenet_table(d["inputs"][valid], outputs[valid])
    tm = tf.mirror_frenet_table(tin[tvalid], tout[tvalid])
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a, b)


def test_jax_table_loads_in_the_port(tmp_path):
    """A table the JAX package's functions assemble and save (from a
    made-up solution: no solver compile) in the port's loader and explicit
    planner; -999 rows stay out."""
    rows = jdatagen.build_lattice(tuple(
        jdatagen.GridSpec(n, lo, hi, 2) for n, lo, hi in
        [("ey", -0.2, 2.0), ("delta", -0.3, 0.3), ("vx_car", 1.0, 7.0),
         ("vy_car", -1.0, 1.0), ("vx_goal", 3.0, 7.0), ("wz", -2.6, 2.6),
         ("epsi", -1.0, 1.0), ("curv", -0.1, 0.1)]))
    rng = np.random.default_rng(0)
    n = len(rows)
    feas = rng.random(n) > 0.25
    sol = J.NMPCSolution(
        jnp.asarray(rng.normal(size=(n, 5)), jnp.float32),
        jnp.asarray(rng.normal(size=(n, 5)), jnp.float32),
        jnp.zeros((n, 6, 7), jnp.float32),
        jnp.asarray(rng.random((n, 86)) > 0.5, jnp.float32),
        jnp.asarray(feas), jnp.zeros((n,), jnp.float32))
    path = str(tmp_path / "frenet_table_jax.npz")
    jdatagen.save_table(path, jdatagen.frenet_table(
        rows, jdatagen.TableSolution.from_solution(sol)))
    inputs, outputs, valid = tf.load_table(path)
    np.testing.assert_array_equal(valid, feas)
    np.testing.assert_array_equal(inputs, rows)
    np.testing.assert_array_equal(outputs[:, :5][feas],
                                  np.asarray(sol.accel)[feas])
    d = np.load(path)
    tt = te.grid_table_from_arrays(d["inputs"], d["outputs"], d["valid"],
                                   device="cpu")
    out, ok = te.grid_lookup(tt, torch.as_tensor(rows))
    np.testing.assert_array_equal(ok.numpy(), feas)
    np.testing.assert_array_equal(out.numpy()[feas], outputs[feas])


# ------------------------------------------- the slice as a whole

def test_table_fit_eval_closed_loop_chain(table, tmp_path):
    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
    from irbfn_tpu_torch.sim import TrackEnv, oval_track
    from irbfn_tpu_torch.train import (eval_offline,
                                       input_bounds_from_config, load_model)
    from irbfn_tpu_torch.dynamics import f1tenth_params

    _, res, _, path = table
    assert res["sol"].feasible.mean() > 0.5
    out_dir = str(tmp_path / "runs")
    fit = tf.main(["--npz_path", path, "--mirror_data", "--direct_fit",
                   "--fit_mode", "per_region", "--num_k", "24", "--run_name",
                   "chain", "--device", "cpu", "--out_dir", out_dir])
    ev = eval_offline.main(["--config_f", os.path.join(out_dir, "chain.json"),
                            "--ckpt", fit["ckpt_dir"], "--npz_path", path,
                            "--mirror", "--device", "cpu"])
    # the healthy sign: the config + checkpoint round trip reproduces the
    # fit's own L1
    assert ev["control_l1"] == pytest.approx(fit["fit_l1"], rel=1e-4)
    assert np.isfinite(ev["picks"]).all()
    model, config = load_model(os.path.join(out_dir, "chain.json"),
                               fit["ckpt_dir"], device="cpu")
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device="cpu")
    planner = IRBFNFrenetPlanner(
        model.eval(), track, input_bounds=input_bounds_from_config(config))
    env = TrackEnv(track, f1tenth_params(device="cpu"), half_width=None)
    sim = env.reset(s0=torch.tensor([0.0, 10.0, 25.0, 40.0]), speed0=1.0,
                    batch_shape=(4,))

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj = env.rollout(sim, policy, n_steps=60)
    assert traj.obs.ey.shape == (60, 4)
    assert bool(torch.isfinite(traj.obs.ey).all())
    assert bool(torch.isfinite(final.x).all())
