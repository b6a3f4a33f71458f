"""The port's demos and plotting entry points: the closed-loop demo, the
overtake demo, the trajectory fan and the sweep plots.

- Each module keeps its JAX script's flags and defaults (output paths
  aside: the port writes under ``torch_runs/``), plus ``--device``.
- The overtake demo's control law against the same law assembled from the
  JAX package's functions (``scripts/export_torch_ckpt.py``'s
  ``overtake_control``, the script's code) on the golden's states, f32 to
  1e-4 (a plan's argmin path through f32 clothoid solves); and its first 30
  steps in both modes against the JAX rollout stored by ``--overtake_golden``
  to 1e-4 m (measured: 4e-6), with the collision flags equal.
- The trajectory fan: the solver fan against the JAX package's f32 solve
  and spiral sampling at ``tests/test_torch_clothoid.py``'s f32 tolerances,
  the net fan (``clothoid_pr``) against the JAX f32 forward at 5e-3 (the
  length head's sum |w| is 5e5, as ``chip_smoke.py`` phase 29 holds it).
- The closed-loop demo drives every planner for a few steps and draws; the
  sweep plots are written from an ``eval_closed_loop`` pickle.
"""

import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics.spiral import sample_path as jsample_path
from irbfn_tpu.solvers import solve_g1_lattice as jsolve_g1_lattice
from irbfn_tpu.train import load_model as jload_model
from irbfn_tpu_torch.planning import demo_traj_fan as fan
from irbfn_tpu_torch.sim import demo_closed_loop as dcl
from irbfn_tpu_torch.sim import demo_overtake as dov
from irbfn_tpu_torch.sim import plot_eval
from irbfn_tpu_torch.train import quadrotor_pipeline, train_ppo
from test_torch_cartesian_chain import reference_defaults

torch.set_num_threads(1)
A = "irbfn_tpu_torch/assets"
OVERTAKE = os.path.join(A, "overtake_golden.npz")
TOL_CONTROL = 1e-4
TOL_TRAJ_M = 1e-4
TOL_PARAMS32 = {0: 1e-6, 1: 5e-7, 4: 3e-5}  # k0, dk, length (clothoid's)
TOL_PATH32 = 1e-4
TOL_NET = 5e-3
PATH_FLAGS = {"save_path", "out"}  # outputs default to torch_runs/


@pytest.mark.parametrize("name,port,argv", [
    ("quadrotor_pipeline", quadrotor_pipeline, []),
    ("train_ppo", train_ppo, []),
    ("demo_closed_loop", dcl, []),
    ("demo_overtake", dov, []),
    ("demo_traj_fan", fan, []),
    ("plot_eval", plot_eval, ["--results", "sweep.pkl"]),
])
def test_flags_match_the_reference_scripts(name, port, argv):
    want = reference_defaults(name, argv)
    got = vars(port.parse_args(argv))
    assert want and set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        if k not in PATH_FLAGS:
            assert got[k] == v, k
    assert set(got) - set(want) <= {"device", "out_dir"}


def _export():
    spec = importlib.util.spec_from_file_location(
        "export_torch_ckpt", os.path.join("scripts", "export_torch_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def overtake():
    with np.load(OVERTAKE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mode", ["pose", "scan"])
def test_torch_overtake_control_matches_jax(overtake, mode):
    flags = ["--device", "cpu"] + (["--from_scan"] if mode == "scan" else [])
    args = dov.parse_args(flags)
    _, _, env, _, control = dov.make_episode(args, "cpu")
    with jax.enable_x64(False):
        _, jenv, _, jcontrol = _export().overtake_world(mode == "scan")
        for k in (0, 12, 29):
            x = overtake[f"{mode}_x"][k]
            st = env.reset(s0=torch.zeros(2))._replace(x=torch.as_tensor(x))
            obs = env.observe(st)
            got = control(st.x, obs["s"], obs.get("scan")).numpy()
            jst = jenv.reset(s0=jnp.zeros(2))._replace(x=jnp.asarray(x))
            jobs = jenv.observe(jst)
            want = np.asarray(jcontrol(jst.x, jobs["s"], jobs.get("scan")))
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_CONTROL,
                                       err_msg=f"step {k}")


@pytest.mark.parametrize("mode", ["pose", "scan"])
def test_torch_overtake_first_steps_match_jax(overtake, mode, tmp_path):
    n = overtake[f"{mode}_x"].shape[0]
    flags = ["--device", "cpu", "--n_steps", str(n)]
    args = dov.parse_args(flags + (["--from_scan"] if mode == "scan" else []))
    out = dov.run(args)
    np.testing.assert_allclose(out["traj_x"], overtake[f"{mode}_x"], rtol=0,
                               atol=TOL_TRAJ_M)
    np.testing.assert_array_equal(out["traj_hit"], overtake[f"{mode}_hit"])
    want = dov.outcome(overtake[f"{mode}_s"], overtake[f"{mode}_hit"],
                       float(out["track"].raceline.length))
    assert {k: out[k] for k in want} == pytest.approx(want, abs=1e-3)
    dov.draw(out, args, str(tmp_path / "overtake.png"))
    assert (tmp_path / "overtake.png").stat().st_size > 1000


def test_torch_traj_fan_solver_matches_jax(tmp_path):
    out = fan.run(fan.parse_args(["--device", "cpu"]))
    with jax.enable_x64(False):
        goals = jnp.asarray(fan.fan_goals())
        pj = jsolve_g1_lattice(goals)
        paths_j = np.asarray(jsample_path(pj, n_points=32))
        pj = np.asarray(pj)
    assert out["paths"].shape == (450, 32, 4) and out["label"] == "solver"
    for col, tol in TOL_PARAMS32.items():
        np.testing.assert_allclose(out["params"][:, col].numpy(), pj[:, col],
                                   rtol=1e-6, atol=tol, err_msg=str(col))
    np.testing.assert_allclose(out["paths"].numpy(), paths_j, rtol=0,
                               atol=TOL_PATH32)
    fan.draw(out, str(tmp_path / "fan.png"))
    assert (tmp_path / "fan.png").stat().st_size > 1000


def test_torch_traj_fan_net_matches_jax():
    out = fan.run(fan.parse_args(["--device", "cpu", "--config_f",
                                  f"{A}/clothoid_pr.json", "--ckpt",
                                  f"{A}/clothoid_pr.npz"]))
    model, variables, _ = jload_model("configs/clothoid_pr.yaml",
                                      "ckpts/clothoid_pr")
    with jax.enable_x64(False):
        v32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           {"params": variables["params"]})
        want = np.asarray(model.apply(v32, jnp.asarray(fan.fan_goals())))
    got = out["params"].numpy()
    assert out["label"] == "net"
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_NET * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("planner", ["pursuit", "irbfn", "irbfn_cart",
                                     "goal_mpc", "goal_mpc_net", "nmpc"])
def test_torch_demo_closed_loop_drives_every_planner(planner, tmp_path):
    nets = {"irbfn": "frenet_wide_pr1", "irbfn_cart": "cart_c1_pr",
            "goal_mpc_net": "goal_mpc_pr"}
    flags = ["--planner", planner, "--n_steps", "2", "--device", "cpu"]
    if planner in nets:
        flags += ["--config_f", f"{A}/{nets[planner]}.json", "--ckpt",
                  f"{A}/{nets[planner]}.npz"]
    out = dcl.run(dcl.parse_args(flags))
    assert np.isfinite(out["ey"]) and not out["crashed"]
    assert out["progress"] > 0.15
    if planner == "pursuit":
        dcl.draw(out, str(tmp_path / "demo.gif"))
        assert (tmp_path / "demo.gif").stat().st_size > 2000


def test_torch_plot_eval_writes_both_figures(tmp_path):
    combos = np.stack(np.meshgrid([0.5, 0.8, 1.1], [1.0, 5.0, 10.0],
                                  indexing="ij"), -1).reshape(-1, 2)
    rng = np.random.default_rng(0)
    res = tmp_path / "sweep.pkl"
    with open(res, "wb") as f:
        pickle.dump({"combos": combos, "ey": rng.uniform(0, 0.1, 9),
                     "epsi": rng.uniform(0, 0.05, 9)}, f)
    paths = plot_eval.main(["--results", str(res), "--out_prefix",
                            str(tmp_path / "figs") + os.sep])
    assert [os.path.basename(p) for p in paths] == ["ey_vs_cs_mu.pdf",
                                                    "ephi_vs_cs_mu.pdf"]
    assert all(os.path.getsize(p) > 1000 for p in paths)
