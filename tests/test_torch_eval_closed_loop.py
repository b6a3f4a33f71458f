"""The port's closed-loop robustness sweep (``sim/eval_closed_loop.py``) and
EXP3 bank experiment (``sim/eval_adaptive.py``) at a small size on the CPU:
every planner runs a 2 x 2 (mu, cs) x 2 trials sweep to finite results in
the reference's result layout, the explicit policy mirrors and brakes as
``scripts/eval_closed_loop.py`` does, the parser has every flag of the
reference script, and misused options fail with a message naming what is
missing.

End to end against the JAX scripts (``scripts/eval_closed_loop.py``,
``scripts/eval_adaptive.py``, run in f32 as deployed) on a tiny track
bundle written in the test (the oval's raceline and its rasterized map):
the grip-adaptive bank (two ``bank6_pr_mu*`` arms), the cartesian planner
and the flagship on the bundle's map with ``--line_csv``, 8 lanes, first
with no start noise, then with the scripts' start noise and a retry
(``--noise_scale 0.01 --max_retries 1``): the port draws JAX's noise from
the same ``--seed`` (``utils/prng.py``). Completion and laps are equal;
mean |ey|, |epsi| and speed agree to 1e-4 and the grip estimate to 1e-3
(f32 rounding over 25 steps of feedback: measured up to 1.5e-5 and
1.9e-5). The EXP3 bank draws JAX's arms: its pulls are equal and its
rewards, like the fixed-arm baselines, agree to 1e-4, with and without
start noise.
"""

import pickle

import numpy as np
import pytest
import torch

from irbfn_tpu_torch.parallel import frenet_table, save_table
from irbfn_tpu_torch.planning.explicit import grid_table_from_arrays
from irbfn_tpu_torch.sim import eval_closed_loop as ev
from irbfn_tpu_torch.sim import oval_track
from irbfn_tpu_torch.sim.env import Observation

torch.set_num_threads(1)
SMALL = ["--device", "cpu", "--num_mu", "2", "--num_cs", "2", "--num_trials",
         "2", "--n_steps", "12"]


def _feedback_table(path, bad_every=0):
    """A Frenet table whose rows are a P-control law of their own inputs, in
    the generator's npz layout."""
    axes = [np.linspace(-1.0, 1.0, 5), np.linspace(-0.4, 0.4, 3),
            np.linspace(0.0, 8.0, 5), np.linspace(-1.0, 1.0, 2),
            np.linspace(2.0, 4.0, 2), np.linspace(-3.0, 3.0, 2),
            np.linspace(-1.0, 1.0, 5), np.linspace(-0.2, 0.2, 3)]
    rows = np.stack([m.reshape(-1) for m in
                     np.meshgrid(*axes, indexing="ij")], -1).astype(np.float32)
    ey, delta, vx, vxg, epsi = (rows[:, i] for i in (0, 1, 2, 4, 6))
    accel = np.clip(2.0 * (vxg - vx), -9.51, 9.51)
    sv = np.clip(-1.0 * ey - 1.5 * epsi - 0.8 * delta, -3.2, 3.2)
    feas = np.ones(len(rows), bool)
    if bad_every:
        feas[::bad_every] = False

    class Sol:
        pass

    sol = Sol()
    sol.accel = np.tile(accel[:, None], (1, 5)).astype(np.float32)
    sol.steer_vel = np.tile(sv[:, None], (1, 5)).astype(np.float32)
    sol.feasible = feas
    sol.active_onehot = np.zeros((len(rows), 0), bool)
    save_table(path, frenet_table(rows, sol))
    return rows, sol


@pytest.mark.parametrize("planner", ["pursuit", "explicit", "nmpc",
                                     "goal_mpc"])
def test_sweep_runs_each_planner(planner, tmp_path):
    argv = SMALL + ["--planner", planner, "--out_name",
                    str(tmp_path / "res")]
    if planner == "explicit":
        path = str(tmp_path / "table.npz")
        _feedback_table(path)
        argv += ["--table_path", path]
    if planner == "nmpc":
        argv += ["--gn_iters", "3", "--al_outer", "1", "--n_steps", "3"]
    res = ev.main(argv)
    with open(tmp_path / "res.pkl", "rb") as f:
        stored = pickle.load(f)
    assert set(stored) == {"combos", "ey", "epsi", "completion", "laps",
                           "vx_mean", "g_est", "planner"}
    assert stored["planner"] == planner and stored["combos"].shape == (4, 2)
    np.testing.assert_allclose(stored["combos"][:, 0], [0.5, 0.5, 1.1, 1.1])
    for k in ("ey", "epsi", "completion", "laps", "vx_mean"):
        assert res[k].shape == (4,) and np.isfinite(res[k]).all(), k
    assert (res["completion"] == 1.0).all()


def test_sweep_with_the_learned_planner_and_tube(tmp_path):
    """``--planner irbfn`` on a net fitted from a feedback table, with the
    visited states saved as a tube and retries counted."""
    from irbfn_tpu_torch.train import train_frenet as tf

    path = str(tmp_path / "table.npz")
    _feedback_table(path)
    fit = tf.main(["--npz_path", path, "--mirror_data", "--direct_fit",
                   "--fit_mode", "per_region", "--num_k", "16", "--run_name",
                   "fb", "--device", "cpu", "--out_dir", str(tmp_path)])
    tube = str(tmp_path / "tube.npz")
    res = ev.main(SMALL + ["--planner", "irbfn", "--config_f",
                           str(tmp_path / "fb.json"), "--ckpt",
                           fit["ckpt_dir"], "--save_tube", tube,
                           "--out_name", str(tmp_path / "res")])
    assert np.isfinite(res["ey"]).all()
    states = np.load(tube)["states"]
    assert states.shape[1] == 8 and len(states) <= 8 * 12 * 3
    assert np.isfinite(states).all()


def test_failed_trials_are_retried_and_counted(tmp_path, capsys):
    """A corridor nothing can stay in: every attempt fails, the sweep
    retries with fresh noise and reports completion 0."""
    res = ev.main(SMALL + ["--planner", "pursuit", "--half_width", "1e-4",
                           "--noise_scale", "0.05", "--max_retries", "1",
                           "--out_name", str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert "attempt 1: 8/8 trials failed" in out
    assert "attempt 2" in out
    assert (res["completion"] == 0.0).all()


def test_explicit_policy_mirrors_and_brakes():
    """The exact-reflection mirror (ey < -0.05 queries the mirrored row and
    un-flips the steer rate) and the hard brake on an infeasible cell."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        rows, sol = _feedback_table(d + "/t.npz")
        z = np.load(d + "/t.npz")
        table = grid_table_from_arrays(z["inputs"], z["outputs"], z["valid"],
                                       device="cpu")
        dead = grid_table_from_arrays(z["inputs"], z["outputs"],
                                      np.zeros(len(rows), bool), device="cpu")
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device="cpu")
    policy = ev.explicit_policy(table, track, 0.5)

    def obs(ey, epsi, delta):
        t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
        return Observation(t(0.0), t(0.0), t(0.0), t(delta), t(3.0), t(0.0),
                           t(0.0), t(0.0), t(5.0), t(ey), t(epsi))

    left, right = policy(obs(0.4, 0.2, 0.1)), policy(obs(-0.4, -0.2, -0.1))
    np.testing.assert_allclose(left[0, 0], right[0, 0], atol=1e-6)
    np.testing.assert_allclose(left[0, 1], -right[0, 1], atol=1e-6)
    assert float(left[0, 1]) == pytest.approx(-0.4 - 0.3 - 0.08, abs=1e-5)
    brake = ev.explicit_policy(dead, track, 0.5)(obs(0.4, 0.2, 0.1))
    np.testing.assert_allclose(brake.numpy(), [[-9.51, 0.0]])


@pytest.mark.parametrize("argv,item", [
    (["--planner", "irbfn_adaptive"], "--bank"),
    (["--planner", "irbfn_cart"], "--config_f"),
    (["--planner", "pursuit", "--map_dir", "maps/x"], "maps/x"),
    (["--planner", "pursuit", "--line_csv", "line.csv"], "--map_dir"),
])
def test_unported_options_raise_and_name_the_roadmap(argv, item, tmp_path):
    """The options the port once refused all run now; misused, each fails
    with a message naming what is missing."""
    with pytest.raises((SystemExit, FileNotFoundError)) as e:
        ev.main(SMALL + argv + ["--out_name", str(tmp_path / "res")])
    assert item in str(e.value)
    assert "ROADMAP" not in str(e.value)


def test_flags_match_the_reference_script():
    """Every flag of the reference script is in the port's parser, with the
    same default."""
    import argparse
    import re

    src = open("scripts/eval_closed_loop.py").read()
    flags = set(re.findall(r'add_argument\("--(\w+)"', src))
    got = vars(ev.parse_args([]))
    assert flags <= set(got), flags - set(got)
    want = dict(re.findall(
        r'add_argument\("--(\w+)", type=(?:int|float), default=([-\d.e]+)',
        src))
    for k, v in want.items():
        assert float(got[k]) == float(v), k
    assert {"bank", "arm_mus", "g0", "pace_lo", "pace_hi", "pace_margin",
            "line", "car_radius", "map_dir", "line_csv"} <= set(want) | {
        "bank", "arm_mus", "line", "map_dir", "line_csv"}
    assert got["line"] == "raceline" and got["bank"] is None
    assert got["planner"] == "nmpc" and got["n_steps"] == 600
    assert got["num_mu"] == got["num_cs"] == got["num_trials"] == 10
    assert isinstance(ev.parse_args(["--device", "cpu"]), argparse.Namespace)


# ------------------------------------------------ against the JAX scripts

A = "irbfn_tpu_torch/assets/"
TINY = ["--num_mu", "2", "--mu_min", "0.6", "--mu_max", "1.0", "--num_cs",
        "2", "--cs_min", "3", "--cs_max", "6", "--num_trials", "2",
        "--n_steps", "25", "--noise_scale", "0", "--max_retries", "0"]
TOL_LOOP = 1e-4
TOL_G = 1e-3


def _jax_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  f"scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv):
    """A JAX script's main() under ``argv``, in f32 as deployed."""
    import sys
    from unittest import mock

    import jax

    mod = _jax_script(name)
    with jax.enable_x64(False), mock.patch.object(sys, "argv",
                                                  [name] + argv):
        mod.main()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny reference-format bundle: the oval's raceline as a CSV and its
    rasterized corridor (half width 2 m) as yaml + png."""
    from irbfn_tpu.sim import oval_track as joval
    from irbfn_tpu.sim.map import rasterize_track, save_map_yaml

    d = tmp_path_factory.mktemp("bundle") / "ovl"
    d.mkdir()
    track = joval(30.0, 15.0, n_samples=512, speed=3.0)
    rl = track.raceline
    cols = np.stack([np.asarray(a, np.float64) for a in
                     (rl.ss, rl.xs, rl.ys, rl.yaws, rl.ks, rl.vxs)], -1)
    np.savetxt(d / "ovl_raceline.csv", cols, delimiter=";", fmt="%.9g",
               header="s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps")
    omap = rasterize_track(track, half_width=2.0)
    save_map_yaml(np.asarray(omap.dist) > 0, float(omap.resolution),
                  (float(omap.origin_x), float(omap.origin_y), 0.0),
                  str(d / "ovl_map.yaml"))
    return str(d)


def _sweep_argv(case, bundle):
    """(JAX argv, port argv) of a sweep case on the tiny bundle."""
    if case == "adaptive_map":
        argv = ["--planner", "irbfn_adaptive", "--arm_mus", "1.0", "0.8",
                "--pace_lo", "0.2", "--speed_scale", "2.5", "--map_dir",
                bundle]
        jbank = [f"configs/bank6_pr_mu{m}.yaml:ckpts/bank6_pr_mu{m}"
                 for m in ARM_MUS[::-1]]
        tbank = [f"{A}bank6_pr_mu{m}.json:{A}bank6_pr_mu{m}.npz"
                 for m in ARM_MUS[::-1]]
        return argv + ["--bank"] + jbank, argv + ["--bank"] + tbank
    if case == "cart":
        argv = ["--planner", "irbfn_cart"]
        return (argv + ["--config_f", "configs/cart_c1_pr.yaml", "--ckpt",
                        "ckpts/cart_c1_pr"],
                argv + ["--config_f", A + "cart_c1_pr.json", "--ckpt",
                        A + "cart_c1_pr.npz"])
    argv = ["--planner", "irbfn", "--map_dir", bundle, "--line_csv",
            bundle + "/ovl_raceline.csv", "--car_radius", "0.15"]
    return (argv + ["--config_f", "configs/frenet_wide_pr1.yaml", "--ckpt",
                    "ckpts/frenet_wide_pr1"],
            argv + ["--config_f", A + "frenet_wide_pr1.json", "--ckpt",
                    A + "frenet_wide_pr1.npz"])


def _compare(res, ref_pkl):
    with open(ref_pkl, "rb") as f:
        ref = pickle.load(f)
    assert set(res) == set(ref) and res["planner"] == ref["planner"]
    np.testing.assert_array_equal(res["combos"], ref["combos"])
    np.testing.assert_array_equal(res["completion"], ref["completion"])
    np.testing.assert_array_equal(res["laps"], ref["laps"])
    for k in ("ey", "epsi", "vx_mean"):
        np.testing.assert_allclose(res[k], ref[k], rtol=0, atol=TOL_LOOP,
                                   err_msg=k)
    np.testing.assert_allclose(res["g_est"], ref["g_est"], rtol=0,
                               atol=TOL_G, equal_nan=True)
    return ref


ARM_MUS = ("0.80", "1.00")


@pytest.mark.parametrize("case", ["adaptive_map", "cart", "flagship_line"])
def test_sweep_matches_the_jax_script(case, bundle, tmp_path):
    common = TINY + ["--out_name"]
    jargv, targv = _sweep_argv(case, bundle)
    _run_jax("eval_closed_loop", common + [str(tmp_path / "jax")] + jargv)
    res = ev.main(["--device", "cpu"] + common + [str(tmp_path / "port")]
                  + targv)
    ref = _compare(res, tmp_path / "jax.pkl")
    assert (ref["completion"] == 1.0).all()
    if case == "adaptive_map":
        assert np.isfinite(res["g_est"]).all()
        assert (res["g_est"] != 0.5).any()  # the observer moved
    else:
        assert np.isnan(res["g_est"]).all()


@pytest.mark.parametrize("case", ["adaptive_map", "flagship_line",
                                  "cart_narrow"])
def test_noisy_sweep_matches_the_jax_script(case, bundle, tmp_path, capsys):
    """The scripts' start noise (0.01) and one retry, drawn by both
    packages from ``--seed 0``: lane by lane the same results. In a
    corridor 40 cm wide (``cart_narrow``) most lanes fail, and their
    results come from the retry, which draws the second key of the
    chain."""
    common = [a for a in TINY] + ["--out_name"]
    common[common.index("--noise_scale") + 1] = "0.01"
    common[common.index("--max_retries") + 1] = "1"
    jargv, targv = _sweep_argv(case.split("_")[0], bundle)
    if case == "cart_narrow":
        jargv, targv = (a + ["--half_width", "0.2"] for a in (jargv, targv))
    _run_jax("eval_closed_loop", common + [str(tmp_path / "jax")] + jargv)
    res = ev.main(["--device", "cpu"] + common + [str(tmp_path / "port")]
                  + targv)
    _compare(res, tmp_path / "jax.pkl")
    if case == "cart_narrow":
        out = capsys.readouterr().out
        assert out.count("attempt 1: ") == 2  # both packages retried
        assert 0 < res["completion"].mean() < 1


def _adaptive_tables(tmp_path):
    """Two feedback tables (one per arm) whose laws differ in gain."""
    paths = []
    for i, gain in enumerate((1.0, 0.6)):
        rows, sol = _feedback_table(str(tmp_path / f"t{i}.npz"))
        d = dict(np.load(tmp_path / f"t{i}.npz"))
        d["outputs"] = (d["outputs"] * gain).astype(np.float32)
        np.savez(tmp_path / f"t{i}.npz", **d)
        paths.append(str(tmp_path / f"t{i}.npz"))
    return paths


@pytest.mark.parametrize("mode", ["tables", "nets"])
def test_eval_adaptive_matches_the_jax_script(mode, bundle, tmp_path):
    from irbfn_tpu_torch.sim import eval_adaptive

    common = ["--arm_mus", "0.8", "1.0", "--map_dir", bundle, "--mus",
              "0.6", "1.0", "--css", "5.0", "--episodes", "2", "--n_steps",
              "20", "--baseline_rounds", "1", "--noise_scale", "0",
              "--json_out"]
    if mode == "tables":
        arms = _adaptive_tables(tmp_path)
        jarms = tarms = ["--tables"] + arms
    else:
        jarms = ["--nets"] + [f"configs/bank6_pr_mu{m}.yaml:"
                              f"ckpts/bank6_pr_mu{m}" for m in ARM_MUS]
        tarms = ["--nets"] + [f"{A}bank6_pr_mu{m}.json:{A}bank6_pr_mu{m}.npz"
                              for m in ARM_MUS]
    import json

    _run_jax("eval_adaptive", common + [str(tmp_path / "j.json")] + jarms)
    res = eval_adaptive.main(["--device", "cpu"] + common
                             + [str(tmp_path / "t.json")] + tarms)
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert set(res) == set(ref) and res["mode"] == ref["mode"]
    np.testing.assert_allclose(res["speed_scales"], ref["speed_scales"],
                               rtol=1e-12)
    np.testing.assert_allclose(res["fixed_rewards"], ref["fixed_rewards"],
                               rtol=0, atol=TOL_LOOP)
    pulls, rewards = np.asarray(res["pulls"]), np.asarray(res["rewards"])
    assert pulls.shape == (2, 2) and ((pulls >= 0) & (pulls < 2)).all()
    assert ((rewards >= 0) & (rewards <= 1)).all()
    # JAX's arms for the same seed, and their rewards
    np.testing.assert_array_equal(pulls, ref["pulls"])
    np.testing.assert_allclose(rewards, ref["rewards"], rtol=0,
                               atol=TOL_LOOP)
    # a pulled arm's reward is that arm's fixed baseline (no start noise)
    fixed = np.asarray(res["fixed_rewards"])
    np.testing.assert_allclose(rewards, fixed[pulls, np.arange(2)],
                               rtol=0, atol=1e-6)


def test_eval_adaptive_with_start_noise_matches_the_jax_script(bundle,
                                                               tmp_path):
    """The learned bank with the script's default start noise (0.01): the
    same noise every round, the same pulls, rewards to 1e-4."""
    import json

    from irbfn_tpu_torch.sim import eval_adaptive

    common = ["--arm_mus", "0.8", "1.0", "--map_dir", bundle, "--mus",
              "0.6", "1.0", "--css", "5.0", "--episodes", "3", "--n_steps",
              "20", "--baseline_rounds", "1", "--json_out"]
    jarms = ["--nets"] + [f"configs/bank6_pr_mu{m}.yaml:"
                          f"ckpts/bank6_pr_mu{m}" for m in ARM_MUS]
    tarms = ["--nets"] + [f"{A}bank6_pr_mu{m}.json:{A}bank6_pr_mu{m}.npz"
                          for m in ARM_MUS]
    _run_jax("eval_adaptive", common + [str(tmp_path / "j.json")] + jarms)
    res = eval_adaptive.main(["--device", "cpu"] + common
                             + [str(tmp_path / "t.json")] + tarms)
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    np.testing.assert_allclose(res["fixed_rewards"], ref["fixed_rewards"],
                               rtol=0, atol=TOL_LOOP)
    np.testing.assert_array_equal(res["pulls"], ref["pulls"])
    np.testing.assert_allclose(res["rewards"], ref["rewards"], rtol=0,
                               atol=TOL_LOOP)
