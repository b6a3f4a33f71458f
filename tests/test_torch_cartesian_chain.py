"""The port's cartesian chain and NMPC table tools against the JAX package,
on the CPU: the cartesian table generator, the straggler patch, the
cartesian trainer, the NMPC-against-oracle report and the constraint
clustering, each at a cut size.

- ``gen_nmpc_table_cartesian.solve_table`` on a 128-row grid in f64 at
  small tiered budgets, against the JAX package's f64 solutions of every row
  at each budget (``cart_chain_golden.npz``, written by
  ``scripts/export_torch_ckpt.py --cart_chain_golden``: a JAX cartesian
  solve compiles for 80-150 s a shape, so the JAX side is stored): flags
  equal outside a 20% band around the KKT tolerance, controls to 1e-6;
- ``patch_table_stragglers`` on that table's flagged rows (cartesian) and
  on a Frenet table with rows marked flagged: the re-solve's budget and the
  patched rows;
- ``train_cartesian`` run by both packages on one table: the same config
  and centers bit for bit, the control L1 of the fit and the fine-tune's
  loss to the f32 grams' tolerance (``tests/test_torch_fit.py``);
- ``eval_nmpc_oracle`` against the stored SLSQP thresholds of
  ``tests/test_nmpc_oracle.py``, and its flagged study;
- ``cluster_constraints`` run by both packages: the same files.
"""

import argparse
import dataclasses
import importlib.util
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from irbfn_tpu_torch.dynamics.params import fullscale_params
from irbfn_tpu_torch.parallel import gen_nmpc_table_cartesian as gen
from irbfn_tpu_torch.parallel import patch_table_stragglers as patch
from irbfn_tpu_torch.parallel.datagen import save_table
from irbfn_tpu_torch.solvers import eval_nmpc_oracle as evo
from irbfn_tpu_torch.solvers import nmpc as T
from irbfn_tpu_torch.train import cluster_constraints as cc
from irbfn_tpu_torch.train import load_config, params_from_jax
from irbfn_tpu_torch.train import train_cartesian as tc

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "irbfn_tpu_torch", "assets",
                      "cart_chain_golden.npz")
KKT_BAND = 0.2  # flags compared where |kkt / kkt_tol - 1| > KKT_BAND
TOL_CONTROLS = 1e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__ + ".py"] + argv)
    mod.main()


class _Parsed(Exception):
    pass


def reference_defaults(name, argv):
    """The parsed flags of the JAX package's ``scripts/<name>.py`` for
    ``argv`` (its parser is built inside ``main``; stopped there)."""
    mod = _script(name)
    real = argparse.ArgumentParser.parse_args
    got = {}

    def parse(self, args=None, namespace=None):
        got.update(vars(real(self, args, namespace)))
        raise _Parsed

    argparse.ArgumentParser.parse_args = parse
    old = sys.argv
    sys.argv = [name] + list(argv)
    try:
        mod.main()
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
        sys.argv = old
    return got


@pytest.mark.parametrize("name,port,argv", [
    ("gen_nmpc_table_cartesian", gen, []),
    ("train_cartesian", tc, ["--npz_path", "t.npz"]),
    ("patch_table_stragglers", patch, ["--npz_path", "t.npz"]),
    ("eval_nmpc_oracle", evo, []),
    ("cluster_constraints", cc, ["--npz_path", "t.npz"]),
])
def test_flags_match_the_reference_scripts(name, port, argv):
    want = reference_defaults(name, argv)
    got = vars(port.parse_args(argv))
    assert want and set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        assert got[k] == v, k


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _tier_args(tmp, extra=()):
    export = _script("export_torch_ckpt")
    tiers = export.CART_TEST_TIERS
    cfg = T.cartesian_config(gn_iters=tiers["gn_iters"],
                             al_outer=tiers["al_outer"])
    args = gen.parse_args(list(export.CART_TEST_ARGS) + [
        "--dtype", "f64", "--device", "cpu", "--save_path", str(tmp),
        "--batch_per_device", "50", "--phase1_iters",
        str(tiers["phase1_iters"]), "--resolve_factor",
        str(tiers["resolve_factor"])] + list(extra))
    return args, cfg


def _jax_tiered(g):
    """The JAX package's tiered table, merged from its solutions of every
    row at each budget; and the budget that decided each row."""
    out = {k: g[f"cheap_{k}"].copy() for k in ("accel", "steer_vel",
                                               "feasible", "kkt")}
    decided = np.zeros(len(g["rows"]), "<U5")
    decided[:] = "cheap"
    for name in ("full", "hard"):
        bad = ~out["feasible"]
        for k in out:
            out[k][bad] = g[f"{name}_{k}"][bad]
        decided[bad] = name
    return out, decided


@pytest.fixture(scope="module")
def table(tmp_path_factory, golden):
    d = tmp_path_factory.mktemp("cart")
    args, cfg = _tier_args(d)
    res = gen.solve_table(args, cfg=cfg)
    path = gen.table_name(args, res["grid"])
    save_table(path, gen.cartesian_table(res["rows"], res["sol"]))
    return args, cfg, res, path


def test_cartesian_table_matches_jax(table, golden):
    args, cfg, res, path = table
    rows = res["rows"]
    np.testing.assert_array_equal(rows, golden["rows"])
    assert rows.shape == (128, 7) and rows.dtype == np.float64
    want, decided = _jax_tiered(golden)
    sol = res["sol"]
    settled = np.abs(want["kkt"] / cfg.kkt_tol - 1.0) > KKT_BAND
    np.testing.assert_array_equal(sol.feasible[settled],
                                  want["feasible"][settled])
    both = sol.feasible & want["feasible"]
    assert both.mean() > 0.5
    for k in ("accel", "steer_vel"):
        np.testing.assert_allclose(getattr(sol, k)[both], want[k][both],
                                   rtol=0.0, atol=TOL_CONTROLS, err_msg=k)
    assert set(res["seconds"]) == {"cheap", "full", "straggler"}
    np.testing.assert_array_equal(res["touched"], ~golden["cheap_feasible"])
    assert res["certified_cheap"] == pytest.approx(
        golden["cheap_feasible"].mean())
    # the reference file: name, keys, (N, 2T) controls, -999 rows
    assert os.path.basename(path) == (
        "cart_table_2x2x2x2x2x2x2_mu1.0_cs5.0.npz")
    with np.load(path) as z:
        assert sorted(z.files) == ["inputs", "outputs", "valid"]
        assert z["outputs"].shape == (128, 10)
        assert (z["outputs"][~z["valid"]] == -999.0).all()
        np.testing.assert_array_equal(z["outputs"][z["valid"], :5],
                                      sol.accel[sol.feasible])


def test_patch_cartesian_table(table, golden, tmp_path):
    """The table made without its straggler pass, patched: the flagged rows
    re-solved at the straggler budget, as the JAX package's hard pass."""
    args, cfg, _, _ = table
    args0, _ = _tier_args(tmp_path, ["--resolve_factor", "0"])
    res = gen.solve_table(args0, cfg=cfg)
    path = str(tmp_path / "c.npz")
    save_table(path, gen.cartesian_table(res["rows"], res["sol"]))
    pargs = patch.parse_args(["--npz_path", path, "--resolve_factor",
                              str(args.resolve_factor), "--dtype", "f64",
                              "--device", "cpu"])
    out = patch.patch(pargs, cfg=cfg)
    bad, rec = out["bad"], out["recovered"]
    np.testing.assert_array_equal(bad, np.nonzero(~res["sol"].feasible)[0])
    assert bad.size
    np.testing.assert_array_equal(rec, golden["hard_feasible"][bad])
    data = out["data"]
    fixed = bad[rec]
    np.testing.assert_allclose(data["outputs"][fixed, :5],
                               golden["hard_accel"][fixed], rtol=0.0,
                               atol=TOL_CONTROLS)
    assert data["valid"][fixed].all()
    assert (data["outputs"][bad[~rec]] == -999.0).all()


def test_patch_frenet_table(tmp_path):
    """A Frenet table with rows marked flagged: only those are re-solved,
    at the multiplied budget, into (N, T, 2) controls and the one-hot."""
    rng = np.random.default_rng(4)
    rows = np.column_stack([
        rng.uniform(-0.2, 2.0, 6), rng.uniform(-0.3, 0.3, 6),
        rng.uniform(1.0, 7.0, 6), rng.uniform(-1.0, 1.0, 6),
        rng.uniform(3.0, 7.0, 6), rng.uniform(-2.6, 2.6, 6),
        rng.uniform(-1.0, 1.0, 6), rng.uniform(-0.1, 0.1, 6)])
    valid = np.array([True, False, True, False, False, True])
    table = {"inputs": rows.astype(np.float32),
             "outputs": np.full((6, 5, 2), 0.5),
             "constraints": np.ones((6, 86)), "valid": valid}
    table["outputs"][~valid] = -999.0
    path = str(tmp_path / "f.npz")
    np.savez(path, **table)
    small = T.NMPCConfig(gn_iters=5, al_outer=2)
    args = patch.parse_args(["--npz_path", path, "--resolve_factor", "2",
                             "--dtype", "f64", "--device", "cpu"])
    out = patch.patch(args, cfg=small)
    np.testing.assert_array_equal(out["bad"], [1, 3, 4])
    hard = dataclasses.replace(small, gn_iters=10, al_outer=4)
    ref = T.solve_lattice_point(
        torch.as_tensor(rows[[1, 3, 4]].astype(np.float32),
                        dtype=torch.float64),
        fullscale_params(dtype=torch.float64, device="cpu"), hard)
    np.testing.assert_array_equal(out["recovered"], ref.feasible.numpy())
    data = out["data"]
    np.testing.assert_array_equal(data["outputs"][[0, 2, 5]], 0.5)
    fixed = np.array([1, 3, 4])[ref.feasible.numpy()]
    assert fixed.size
    got = data["outputs"][fixed]
    want = np.stack([ref.accel.numpy(), ref.steer_vel.numpy()],
                    -1)[ref.feasible.numpy()]
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
    np.testing.assert_array_equal(
        data["constraints"][fixed],
        ref.active_onehot.numpy()[ref.feasible.numpy()])
    main_out = patch.main(["--npz_path", path, "--out",
                           str(tmp_path / "g.npz"), "--resolve_factor", "2",
                           "--dtype", "f64", "--device", "cpu"])
    with np.load(main_out) as z:
        assert sorted(z.files) == sorted(table)


def _nums(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


def test_train_cartesian_matches_jax(golden, tmp_path, monkeypatch, capfd):
    """The JAX package's tiered table (from the golden) trained by both
    packages: mirror, per-region closed form, then one fine-tune epoch of
    the cartesian integration loss."""
    from irbfn_tpu.train import load_model as jload

    want, _ = _jax_tiered(golden)
    npz = str(tmp_path / "cart.npz")
    save_table(npz, gen.cartesian_table(golden["rows"].astype(np.float32),
                                        type("S", (), want)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", [ROOT] + sys.path)
    recipe = ["--npz_path", npz, "--run_name", "cart", "--direct_fit",
              "--fit_mode", "per_region", "--num_k", "16", "--num_t_goal",
              "2", "--mirror_data", "--finetune_epochs", "1",
              "--batch_size", "64"]
    capfd.readouterr()
    with jax.enable_x64(False):
        _run_script(_script("train_cartesian"), recipe, monkeypatch)
    j_out = capfd.readouterr().out
    res = tc.main(recipe + ["--device", "cpu", "--out_dir", "out"])
    t_out = capfd.readouterr().out
    with jax.enable_x64(False):
        _, jvars, jconfig = jload("configs/cart.yaml", "ckpts/cart")
    config = load_config("out/cart.json")
    assert config == jconfig
    # the step-0 checkpoints: the fit, whose centers are the same draws
    from irbfn_tpu_torch.train import restore_params
    from irbfn_tpu.train import restore_params as jrestore

    t0 = params_from_jax(restore_params("out/cart", step=0), config)
    j0 = params_from_jax(jax.tree.map(np.asarray, jrestore(
        os.path.abspath("ckpts/cart"), step=0)), config)
    for k in ("centers", "log_sigs"):
        assert torch.equal(t0[k], j0[k]), k
    line = [ln for ln in t_out.splitlines() if ln.startswith("control L1")]
    jline = [ln for ln in j_out.splitlines() if ln.startswith("control L1")]
    # f32 grams of a 1e-5-ridge system (tests/test_torch_fit.py)
    np.testing.assert_allclose(_nums(line[0])[0], _nums(jline[0])[0],
                               rtol=1e-2)
    assert line[0].split("(")[1] == jline[0].split("(")[1]
    np.testing.assert_allclose(res["fit_l1"], _nums(line[0])[0], atol=1e-4)
    jl = [ln for ln in j_out.splitlines() if ln.startswith("final mean")]
    np.testing.assert_allclose(res["final_loss"], _nums(jl[0])[0],
                               rtol=5e-2)
    assert os.path.exists("out/cart.metrics.jsonl")


def test_eval_nmpc_oracle_report(tmp_path):
    m = evo.main(["--n_rows", "4", "--device", "cpu", "--json_out",
                  str(tmp_path / "m.json")])
    assert m["n_rows"] == 4
    assert m["oracle_misses_al_feasible"] <= 1
    assert m["both_feasible"] >= 3
    # tests/test_nmpc_oracle.py's objective thresholds (its control ones are
    # percentiles over 100 rows; on 4 a row where SLSQP stops early, its
    # objective 6e-7 above the solver's, moves the median)
    assert m["rel_obj_gap_p50"] < 1e-10
    assert m["rel_obj_gap_max"] < 1e-4
    assert os.path.exists(tmp_path / "m.json")
    rows = evo.sample_rows(8, 7)
    rng = np.random.default_rng(7)  # the reference script's draws
    np.testing.assert_array_equal(rows[:, 0], rng.uniform(-0.2, 2.0, 8))
    np.testing.assert_array_equal(rows[:, 1], rng.uniform(-0.3, 0.3, 8))


def test_eval_nmpc_oracle_flagged_study():
    small = T.NMPCConfig(gn_iters=4, al_outer=2)
    m = evo.main(["--n_rows", "6", "--flagged_study", "--device", "cpu",
                  "--resolve_factor", "4"], cfg=small)
    assert m["flagged"] >= 1
    assert 0 <= m["recovered_by_resolve"] <= m["flagged"]
    assert m["recovered_of_oracle_solvable"] <= m[
        "oracle_solvable_of_flagged"]
    assert m["flagged_frac"] == pytest.approx(m["flagged"] / 6)


def test_cluster_constraints_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    n = 400
    pats = (rng.random((9, 86)) > 0.5).astype(np.float64)
    constraints = pats[rng.integers(0, 9, n)]
    inputs = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    monkeypatch.chdir(tmp_path)
    for d in ("j", "t"):
        os.makedirs(d)
        np.savez(os.path.join(d, "tab.npz"), inputs=inputs,
                 constraints=constraints)
    monkeypatch.setattr(sys, "path", [ROOT] + sys.path)
    _run_script(_script("cluster_constraints"),
                ["--npz_path", "j/tab.npz", "--top_k", "5"], monkeypatch)
    paths = cc.main(["--npz_path", "t/tab.npz", "--top_k", "5"])
    assert [os.path.basename(p) for p in paths] == [
        "tab_top5mode.npz", "tab_5_cluster_ids.npz"]
    for p in paths:
        with np.load(p) as zt, np.load(p.replace("t/", "j/", 1)) as zj:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zt.files:
                np.testing.assert_array_equal(zt[k], zj[k])
