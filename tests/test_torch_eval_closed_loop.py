"""The port's closed-loop robustness sweep (``sim/eval_closed_loop.py``) at
a small size on the CPU: every planner it has runs a 2 x 2 (mu, cs) x 2
trials sweep to finite results in the reference's result layout, the
explicit policy mirrors and brakes as ``scripts/eval_closed_loop.py`` does,
and what is not ported yet raises, naming its ROADMAP item.
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
    (["--planner", "irbfn_adaptive"], "item 6"),
    (["--planner", "irbfn_cart"], "item 6"),
    (["--planner", "pursuit", "--map_dir", "maps/x"], "sim/map.py"),
    (["--planner", "pursuit", "--line_csv", "line.csv"], "sim/map.py"),
])
def test_unported_options_raise_and_name_the_roadmap(argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        ev.main(SMALL + argv + ["--out_name", str(tmp_path / "res")])
    assert item in str(e.value)


def test_flags_match_the_reference_script():
    """Every flag of the reference script that the port serves, with the
    same default."""
    import argparse
    import re

    src = open("scripts/eval_closed_loop.py").read()
    want = dict(re.findall(
        r'add_argument\("--(\w+)", type=(?:int|float), default=([-\d.e]+)',
        src))
    got = vars(ev.parse_args([]))
    served = {k: float(v) for k, v in want.items() if k in got}
    assert {"horizon", "ctrl_dt", "speed_scale", "oval_scale", "half_width",
            "max_retries", "gn_iters", "al_outer"} <= set(served)
    for k, v in served.items():
        assert float(got[k]) == v, k
    assert got["planner"] == "nmpc" and got["n_steps"] == 600
    assert got["num_mu"] == got["num_cs"] == got["num_trials"] == 10
    assert isinstance(ev.parse_args(["--device", "cpu"]), argparse.Namespace)
