"""The port's sharded lattice solve (``parallel/datagen.py:
solve_lattice_sharded``, ``solvers/goal_mpc.py:solve_goal_lattice_sharded``)
vs its one-device solve and the JAX package's sharded solves.

- World 1 (no process group, in the test process): bit for bit
  ``solve_lattice``'s and ``solve_goal_lattice``'s result at the same
  ``batch_per_device``, for a dict of tensors, a bool column and a solver
  that returns one tensor; and the goal and clothoid table producers, run
  as they are, write the arrays they wrote through the one-device solve.
- ``torchrun`` with two gloo ranks: the goal table producer writes, from
  rank 0 alone, the world-1 run's table.
- Worlds 2 and 3 (one gloo spawn each; world 3 leaves the last rank an
  empty block of the last chunk): on every rank, the whole table, equal to
  ``solve_lattice`` at the same ``batch_per_device`` on that rank, in f32
  and f64, whose call gathers nothing while the sharded one does; the
  goal family in f64 within ``tests/test_goal_mpc.py::
  test_goal_lattice_sharded_matches_direct``'s atol 1e-6 of JAX's
  ``solve_goal_lattice_sharded`` on the 8-device mesh, with equal
  ``converged`` (in f32 two packages' ADMM sums differ by their order over
  the sweeps, 3.8e-6 here: ``tests/test_torch_goal_mpc.py`` holds f32 at
  1e-5); the clothoid rows of ``tests/test_end_to_end.py::
  test_sharded_datagen_matches_direct`` at rtol 1e-10 in f64 of JAX's.
"""

import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.solvers import clothoid as jclothoid
from irbfn_tpu.solvers import goal_mpc as jgoal
from irbfn_tpu_torch.parallel import (GridSpec, build_lattice, datagen,
                                      launch, rank_checks)
from irbfn_tpu_torch.parallel import gen_clothoid_lut, gen_goal_mpc_table
from irbfn_tpu_torch.solvers import goal_mpc as tgoal
from irbfn_tpu_torch.solvers.clothoid import solve_g1_lattice

torch.set_num_threads(1)

V_CAR = 2.5
ITERS = 300
GOAL_BPD = 8
CLOTHOID_BPD = 128


def _goals(dtype=np.float32):
    """The goal block of tests/test_goal_mpc.py's sharded test."""
    rng = np.random.default_rng(5)
    G = 64
    return np.stack([rng.uniform(-1.2, 4.0, G), rng.uniform(0.0, 4.0, G),
                     rng.uniform(-1.0, 8.0, G),
                     rng.uniform(-3.14, 3.14, G)], axis=1).astype(dtype)


def _clothoid_goals():
    """The lattice of tests/test_end_to_end.py, f64."""
    grid = (GridSpec("x", 8.0, 20.0, 9), GridSpec("y", -4.0, 4.0, 9),
            GridSpec("theta", -0.8, 0.8, 9))
    return build_lattice(grid, dtype=np.float64)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_goal():
    out = jgoal.solve_goal_lattice_sharded(np.float64(V_CAR),
                                           _goals(np.float64), iters=ITERS,
                                           batch_per_device=GOAL_BPD)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_clothoid():
    return np.asarray(jclothoid.solve_g1_lattice(jnp.asarray(
        _clothoid_goals())))


def test_torch_world_one_is_solve_lattice_bit_for_bit():
    goals = _goals()
    kw = dict(iters=ITERS, batch_per_device=GOAL_BPD, device="cpu")
    sharded = tgoal.solve_goal_lattice_sharded(V_CAR, goals, **kw)
    direct = tgoal.solve_goal_lattice(V_CAR, goals, **kw)
    assert sharded["converged"].dtype == np.bool_
    _assert_same(sharded, direct)

    rows = _clothoid_goals()
    bare = datagen.solve_lattice_sharded(solve_g1_lattice, rows,
                                         batch_per_device=CLOTHOID_BPD,
                                         device="cpu")
    ref = datagen.solve_lattice(lambda r: {"p": solve_g1_lattice(r)}, rows,
                                batch_per_device=CLOTHOID_BPD, device="cpu")
    np.testing.assert_array_equal(bare, ref["p"])


def test_torch_producers_write_what_the_one_device_solve_wrote(tmp_path,
                                                               monkeypatch):
    """The goal table and the clothoid LUT at cut grids: the files of the
    sharded producers (a world of one) against the same runs with the
    sharded solve replaced by the one-device one, key by key."""
    goal_flags = ["--device", "cpu", "--d_x_goal", "1.3", "--d_y_goal",
                  "1.0", "--d_t_goal", "1.57", "--d_v_car", "4.5",
                  "--d_v_goal", "4.5", "--iters", "100", "--chunk", "100"]
    lut_flags = ["--device", "cpu", "--dx", "5.0", "--dy", "4.0", "--dt",
                 "0.8", "--batch_per_device", "64"]
    runs = {}
    for tag in ("sharded", "direct"):
        d = tmp_path / tag
        d.mkdir()
        if tag == "direct":
            monkeypatch.setattr(
                gen_goal_mpc_table, "solve_goal_lattice_sharded",
                lambda v, g, cfg, iters, mesh, batch_per_device:
                tgoal.solve_goal_lattice(v, g, cfg, iters=iters,
                                         batch_per_device=batch_per_device,
                                         device="cpu"))
            monkeypatch.setattr(
                gen_clothoid_lut, "solve_lattice_sharded",
                lambda fn, rows, mesh, batch_per_device:
                datagen.solve_lattice(fn, rows,
                                      batch_per_device=batch_per_device,
                                      device="cpu"))
        files = (gen_goal_mpc_table.main(goal_flags + ["--save_path",
                                                       str(d)]),
                 gen_clothoid_lut.main(lut_flags + ["--save_path", str(d)]))
        runs[tag] = []
        for f in files:
            with np.load(f) as z:
                runs[tag].append({k: z[k] for k in z.files})
    for a, b in zip(runs["sharded"], runs["direct"]):
        _assert_same(a, b)


def test_torch_goal_table_under_torchrun(tmp_path):
    """``torchrun`` with two gloo ranks: rank 0 alone writes the table, and
    it is the world-1 run's, key by key (each rank solved 60 goals of every
    120-goal chunk, the world-1 run's 60-goal chunks)."""
    flags = ["--device", "cpu", "--d_x_goal", "1.3", "--d_y_goal", "1.0",
             "--d_t_goal", "1.57", "--d_v_car", "4.5", "--d_v_goal", "4.5",
             "--iters", "100", "--chunk", "60"]
    one = gen_goal_mpc_table.main(flags + ["--save_path", str(tmp_path)])
    two = tmp_path / "two"
    two.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # a session of its own, so that a timeout ends the ranks with the agent
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "irbfn_tpu_torch.parallel.gen_goal_mpc_table", *flags,
         "--save_path", str(two)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert out.count("saved ") == 1, out
    with np.load(one) as a, np.load(two / os.path.basename(one)) as b:
        _assert_same({k: a[k] for k in a.files}, {k: b[k] for k in b.files})


@pytest.mark.parametrize("world", [2, 3])
def test_torch_sharded_lattices_across_ranks(world, tmp_path, jax_goal,
                                             jax_clothoid):
    jobs = [("goal_lattice", V_CAR, _goals(), ITERS, GOAL_BPD),
            ("goal_lattice", V_CAR, _goals(np.float64), ITERS, GOAL_BPD),
            ("clothoid_lattice", _clothoid_goals(), CLOTHOID_BPD)]
    per_rank = launch.spawn(rank_checks.run_jobs, world, "cpu", jobs,
                            store_dir=tmp_path)
    for rank, (goal, goal64, clothoid) in enumerate(per_rank):
        for g in (goal, goal64):
            _assert_same(g["sharded"], g["direct"])
        _assert_same(goal["sharded"], per_rank[0][0]["sharded"])
        for k in ("speed", "steer"):
            np.testing.assert_allclose(goal64["sharded"][k], jax_goal[k],
                                       atol=1e-6, err_msg=f"rank {rank} {k}")
        np.testing.assert_array_equal(goal64["sharded"]["converged"],
                                      jax_goal["converged"])
        np.testing.assert_array_equal(clothoid["sharded"],
                                      clothoid["direct"])
        np.testing.assert_allclose(clothoid["sharded"], jax_clothoid,
                                   rtol=1e-10, atol=1e-12)
        for job in (goal, goal64, clothoid):
            # the direct solve is a world of one inside the process group
            assert not {"lattice.gather_bytes", "lattice.pad_rows"} & set(
                job["moved"]["direct"]), (rank, job["moved"])
            assert job["moved"]["sharded"]["lattice.gather_bytes"] > 0
