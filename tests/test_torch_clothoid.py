"""The port's clothoid pipeline against the JAX package, on the CPU: the G1
solver, the port's native module, Levenberg-Marquardt, the LUT writer, the
lattice planner, and the clothoid net's recipe (``train_clothoid``) and
evaluation (``eval_lut_accuracy``) on a cut LUT, each entry point run by
both packages on the same files.

Tolerances: f64 solver 1e-12 absolute on k0, dk and length; against the
port's C++ oracle rtol 1e-8 (``tests/test_native.py``'s); f32 solver, as
measured on 4,000 seeded goals (k0 2.4e-7, dk 9e-8, length 7.6e-6 at
most; 2.4e-7 relative on a short-chord goal's dk of 47): 1e-6, 5e-7 and
3e-5 absolute, 1e-6 relative; LM iterates 1e-10 (f64); the planner 1e-10 in
f64 (oracle mode) and 1e-9 (net mode); the fit's centers bit for bit.
"""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.dynamics import integrate_endpoint_gl as j_endpoint
from irbfn_tpu.models import fit as jfit
from irbfn_tpu.planning import lattice as jlat
from irbfn_tpu.solvers import clothoid as jcl
from irbfn_tpu.solvers.lm import levenberg_marquardt as j_lm
from irbfn_tpu_torch import native
from irbfn_tpu_torch.dynamics.spiral import (clothoid_to_params,
                                             integrate_endpoint_gl)
from irbfn_tpu_torch.models import fit as tfit
from irbfn_tpu_torch.parallel import datagen
from irbfn_tpu_torch.parallel import gen_clothoid_lut as tgen
from irbfn_tpu_torch.planning import lattice as tlat
from irbfn_tpu_torch.solvers import clothoid as tcl
from irbfn_tpu_torch.solvers.lm import levenberg_marquardt as t_lm
from irbfn_tpu_torch.train import (load_config, load_model, params_from_jax,
                                   save_checkpoint)
from irbfn_tpu_torch.train import eval_lut_accuracy as teval
from irbfn_tpu_torch.train import train_clothoid as ttrain
from irbfn_tpu_torch.utils.args import add_clothoid_grid_args

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "irbfn_tpu_torch", "assets")
TOL_F64 = 1e-12
TOL_F32 = {"k0": 1e-6, "dk": 5e-7, "length": 3e-5}
# a cut LUT: 11 x 9 x 9 = 891 goals over the reference ranges
CUT_GRID = ["--dx", "2.5", "--dy", "2.0", "--dt", "0.4"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__ + ".py"] + argv)
    mod.main()


def _goals(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    g = np.stack([rng.uniform(5, 30, n), rng.uniform(-8, 8, n),
                  rng.uniform(-1.57, 1.57, n)], axis=-1)
    g[:4] = [[10.0, 0.0, 0.0], [5.0, 5.0, np.pi / 2], [0.3, 0.1, 3.0],
             [1e-13, 0.0, 0.0]]  # straight, arc, short chord, degenerate
    return g


# ------------------------------------------------------------- the solver

def test_flags_match_the_reference():
    import argparse

    from irbfn_tpu.utils.args import add_clothoid_grid_args as j_add

    got = vars(add_clothoid_grid_args(argparse.ArgumentParser())
               .parse_args([]))
    assert got == vars(j_add(argparse.ArgumentParser()).parse_args([]))
    args = tgen.parse_args(["--device", "cpu"])
    assert [g.num for g in tgen.grid_from_args(args)] == [251, 161, 158]
    assert [(g.lo, g.hi, g.num) for g in tgen.grid_from_args(args)] == [
        (g.lo, g.hi, g.num) for g in datagen.CLOTHOID_GRID]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_solver_matches_jax(dtype):
    g = _goals()
    x64 = dtype == "f64"
    jdt, tdt = ((jnp.float64, torch.float64) if x64
                else (jnp.float32, torch.float32))
    with jax.enable_x64(x64):
        j = jcl.solve_g1_hermite(*(jnp.asarray(g[:, i], jdt)
                                   for i in range(3)))
        j = [np.asarray(a) for a in j]
    t = tcl.solve_g1_hermite(*(torch.as_tensor(g[:, i], dtype=tdt)
                               for i in range(3)), chunk=1000)
    for k, a in zip(tcl.ClothoidSolution._fields, j):
        b = getattr(t, k).numpy()
        assert b.dtype == a.dtype, k
        if k == "converged":
            if x64:  # |Y| < 1e-8 is a coin flip in f32
                np.testing.assert_array_equal(b, a)
            continue
        tol = TOL_F64 if x64 else TOL_F32.get(k, 1e-6)
        np.testing.assert_allclose(b, a, rtol=0.0 if x64 else 1e-6,
                                   atol=tol, err_msg=k)
    assert not t.converged[3] and float(t.length[3]) == 0.0


def test_solver_chunks_and_lattice_layout():
    g = torch.as_tensor(_goals(300), dtype=torch.float64)
    one = tcl.solve_g1_hermite(g[:, 0], g[:, 1], g[:, 2])
    many = tcl.solve_g1_hermite(g[:, 0], g[:, 1], g[:, 2], chunk=7)
    for a, b in zip(one, many):  # the node sums' order may follow the rows
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13,
                                   atol=1e-15)
    p = tcl.solve_g1_lattice(g.reshape(10, 30, 3))
    assert p.shape == (10, 30, 5)
    assert torch.equal(p.reshape(-1, 5), one.params)


def test_solver_matches_the_native_oracle():
    g = _goals(500)[4:]
    oracle, status = native.clothoid_oracle(g)
    ok = status == 0
    assert ok.mean() > 0.99
    p = tcl.solve_g1_lattice(torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(p[ok], oracle[ok], rtol=1e-8, atol=1e-9)


def test_straight_line():
    sol = tcl.solve_g1_hermite(torch.tensor(10.0, dtype=torch.float64),
                               torch.tensor(0.0, dtype=torch.float64),
                               torch.tensor(0.0, dtype=torch.float64))
    assert abs(float(sol.k0)) < 1e-12 and abs(float(sol.dk)) < 1e-12
    np.testing.assert_allclose(float(sol.length), 10.0, rtol=1e-12)
    assert bool(sol.converged)


def test_quarter_circle():
    R = 5.0
    sol = tcl.solve_g1_hermite(*(torch.tensor(v, dtype=torch.float64)
                                 for v in (R, R, np.pi / 2)))
    np.testing.assert_allclose(float(sol.k0), 1.0 / R, rtol=1e-9)
    assert abs(float(sol.dk)) < 1e-9
    np.testing.assert_allclose(float(sol.length), R * np.pi / 2, rtol=1e-9)


def test_lattice_endpoint_error():
    """The JAX package's bar: endpoint error < 1e-6 over a 9^3 lattice of
    the reference ranges."""
    X, Y, T = np.meshgrid(np.linspace(5.0, 30.0, 9), np.linspace(-8, 8, 9),
                          np.linspace(-1.57, 1.57, 9), indexing="ij")
    goals = torch.as_tensor(np.stack([X, Y, T], -1).reshape(-1, 3))
    end = integrate_endpoint_gl(tcl.solve_g1_lattice(goals))
    pos = torch.hypot(end[:, 0] - goals[:, 0], end[:, 1] - goals[:, 1])
    th = tcl.wrap_angle(end[:, 2] - goals[:, 2]).abs()
    assert float(pos.max()) < 1e-6 and float(th.max()) < 1e-6


def test_lut_param_layout():
    k0, k1, k2, k3, s = tcl.solve_g1_lattice(
        torch.tensor([[10.0, 3.0, 0.5]], dtype=torch.float64))[0].tolist()
    np.testing.assert_allclose(k1 - k0, (k3 - k0) / 3.0, rtol=1e-9)
    np.testing.assert_allclose(k2 - k0, 2.0 * (k3 - k0) / 3.0, rtol=1e-9)
    assert s > 10.0


# ------------------------------------------------------ the native module

def test_native_builds_its_own_copy():
    """The library is built from the port's copies of the sources into
    ``build/native/``; the copies' code is the repository's."""
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parents[1] == native.BUILD_DIR.parent
    assert native.BUILD_DIR.parent.name == "build"
    for src in native.SOURCES:
        with open(os.path.join(ROOT, "native", src)) as a, open(
                native.CSRC_DIR / src) as b:
            code = [[ln for ln in f.read().splitlines()
                     if not ln.startswith("//")] for f in (a, b)]
        assert code[0] == code[1], src


def test_native_without_a_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_native_oracle_single_and_edt():
    status, k0, dk, length = native.clothoid_g1_solve(0, 0, 0, 10, 0, 0)
    assert status == 0 and abs(k0) < 1e-12 and abs(dk) < 1e-12
    np.testing.assert_allclose(length, 10.0, rtol=1e-12)
    out, st = native.clothoid_oracle(np.array([[10.0, 0.0, 0.0]]))
    np.testing.assert_allclose(out[0], [0, 0, 0, 0, 10.0], atol=1e-12)
    from scipy.ndimage import distance_transform_edt

    free = np.ones((40, 50))
    free[10:20, 30:35] = 0
    free[0, :] = 0
    np.testing.assert_allclose(native.edt(free, 0.05),
                               0.05 * distance_transform_edt(free),
                               rtol=0.0, atol=1e-6)


def test_native_table_store_roundtrip(tmp_path):
    path = str(tmp_path / "t.tbl")
    store = native.TableStore.create(path, in_dim=3, out_dim=10)
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(100, 3)).astype(np.float32)
    ys = rng.normal(size=(100, 5, 2)).astype(np.float32)  # (N, T, 2)
    valid = (rng.uniform(size=100) > 0.2).astype(np.float32)
    store.append(xs[:60], ys[:60], valid[:60])
    store.append(xs[60:], ys[60:], valid[60:])
    block = datagen.controls_block(ys)
    with store as t:
        assert (t.n_rows, t.in_dim, t.out_dim) == (100, 3, 10)
        xi, yi, vi = t.read_range(0, 100)
        np.testing.assert_array_equal(xi, xs)
        np.testing.assert_array_equal(yi, block)
        np.testing.assert_array_equal(vi, valid > 0.5)
        idx = rng.permutation(100)[:32]
        xg, yg, vg = t.gather(idx)
        np.testing.assert_array_equal(xg, xs[idx])
        np.testing.assert_array_equal(yg, block[idx])


# ------------------------------------------------------------------- LM

def _rosen_j(x, args):
    a, b = args
    return jnp.stack([a - x[0], jnp.sqrt(b) * (x[1] - x[0] ** 2)])


def _rosen_t(x, args):
    a, b = args
    return torch.stack([a - x[0], torch.sqrt(b) * (x[1] - x[0] ** 2)])


@pytest.mark.parametrize("max_iters", [3, 7, 100])
def test_lm_iterates_match_jax(max_iters):
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2, 2, (16, 2))
    a, b = rng.uniform(0.5, 2, 16), rng.uniform(10, 100, 16)
    j = j_lm(_rosen_j, jnp.asarray(x0), (jnp.asarray(a), jnp.asarray(b)),
             max_iters=max_iters)
    t = t_lm(_rosen_t, torch.as_tensor(x0),
             (torch.as_tensor(a), torch.as_tensor(b)), max_iters=max_iters)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0.0,
                               atol=1e-10)
    np.testing.assert_array_equal(t.iterations.numpy(),
                                  np.asarray(j.iterations))
    np.testing.assert_array_equal(t.converged.numpy(),
                                  np.asarray(j.converged))
    np.testing.assert_allclose(t.residual_norm.numpy(),
                               np.asarray(j.residual_norm), rtol=1e-8,
                               atol=1e-12)


def test_lm_solves_rosenbrock_batch():
    x0 = torch.tensor([-1.2, 1.0], dtype=torch.float64).repeat(16, 1)
    args = (torch.ones(16, dtype=torch.float64),
            100.0 * torch.ones(16, dtype=torch.float64))
    out = t_lm(_rosen_t, x0, args, max_iters=100)
    np.testing.assert_allclose(out.x.numpy(), 1.0, atol=1e-6)
    assert bool(out.converged.all())


def test_lm_spiral_bvp_matches_jax():
    """LM shooting on the cubic-spiral BVP reproduces a clothoid, with the
    JAX package's iterates."""
    from irbfn_tpu.dynamics.spiral import clothoid_to_params as j_c2p

    goal = np.array([12.0, 2.0, 0.3])

    def res_t(z, g):
        s = 1.0 + torch.nn.functional.softplus(z[2])
        end = integrate_endpoint_gl(clothoid_to_params(z[0], z[1], s))
        return torch.stack([end[0] - g[0], end[1] - g[1],
                            tcl.wrap_angle(end[2] - g[2])])

    def res_j(z, g):
        s = 1.0 + jnp.logaddexp(0.0, z[2])
        end = j_endpoint(j_c2p(z[0], z[1], s))
        return jnp.stack([end[0] - g[0], end[1] - g[1],
                          jcl.wrap_angle(end[2] - g[2])])

    z0 = np.array([0.0, 0.0, np.log(np.expm1(np.hypot(12, 2) - 1.0))])
    out = t_lm(res_t, torch.as_tensor(z0), torch.as_tensor(goal),
               max_iters=60)
    assert float(out.residual_norm) < 1e-8
    ref = j_lm(res_j, jnp.asarray(z0), jnp.asarray(goal), max_iters=60)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0.0,
                               atol=1e-10)
    assert int(out.iterations) == int(ref.iterations)


# ------------------------------------------------------ the lattice planner

@pytest.fixture(scope="module")
def clothoid_net():
    """The committed clothoid_pr in f64 in both packages."""
    from irbfn_tpu.train import load_model as jload

    jmodel, jvars, _ = jload(os.path.join(ROOT, "configs", "clothoid_pr.yaml"),
                             os.path.join(ROOT, "ckpts", "clothoid_pr"))
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       {"params": jvars["params"]})
    net, _ = load_model(os.path.join(ASSETS, "clothoid_pr.json"),
                        os.path.join(ASSETS, "clothoid_pr.npz"),
                        device="cpu", dtype=torch.float64)
    return jmodel, v64, net.eval()


@pytest.mark.parametrize("mode", ["oracle", "net"])
@pytest.mark.parametrize("obstacles", [None, ((6.0, 0.5), (9.0, -2.0))])
def test_plan_lattice_matches_jax_f64(mode, obstacles, clothoid_net):
    jmodel, v64, net = clothoid_net
    goals = np.asarray(jlat.sample_lookahead_grid(15.0, 6.0, 8, 9, 5),
                       np.float64)
    tgoals = tlat.sample_lookahead_grid(15.0, 6.0, 8, 9, 5,
                                        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tgoals.numpy(), goals)
    if mode == "oracle":
        jfn, tfn = jcl.solve_g1_lattice, tcl.solve_g1_lattice
        tol = 1e-10
    else:
        def jfn(g):
            return jmodel.apply(v64, g)

        def tfn(g):
            with torch.no_grad():
                return net(g)
        tol = 1e-9
    target = np.array([12.0, 1.5])
    j = jlat.plan_lattice(jfn, jnp.asarray(goals), jnp.asarray(target),
                          obstacle_xy=None if obstacles is None
                          else jnp.asarray(obstacles))
    t = tlat.plan_lattice(tfn, tgoals, target, obstacle_xy=obstacles)
    for k in ("costs", "weights", "best_params", "best_path",
              "argmin_params", "argmin_path"):
        a, b = np.asarray(getattr(j, k)), getattr(t, k).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0.0, atol=tol * scale,
                                   err_msg=k)
    assert int(np.argmin(np.asarray(j.costs))) == int(t.costs.argmin())


@pytest.mark.parametrize("mode", ["net", "oracle"])
def test_lattice_planner_matches_the_golden(mode):
    """``LatticePlanner`` in f32 against the JAX package's f32 plans that
    the card is held against (``clothoid_golden.npz``)."""
    with np.load(os.path.join(ASSETS, "clothoid_golden.npz")) as z:
        g = {k: z[k] for k in z.files if k.startswith("plan_")}
    model = None
    if mode == "net":
        model = load_model(os.path.join(ASSETS, "clothoid_pr.json"),
                           os.path.join(ASSETS, "clothoid_pr.npz"),
                           device="cpu")[0].eval()
    planner = tlat.LatticePlanner(model, device="cpu")
    np.testing.assert_array_equal(planner.goals.numpy(), g["plan_goals"])
    if model is not None:  # the net's f32 spirals (sum |w| 5e5 on s)
        with torch.no_grad():
            np.testing.assert_allclose(model(planner.goals).numpy(),
                                       g["plan_net_params"], rtol=0.0,
                                       atol=5e-3)
    for case, obs in (("free", None), ("obs", g["plan_obstacles"])):
        plan = planner.plan(g["plan_target"], obs)
        pre = f"plan_{mode}_{case}_"
        assert int(plan.costs.argmin()) == int(g[pre + "costs"].argmin())
        for k, tol in (("costs", 2e-3), ("weights", 2e-3),
                       ("best_params", 2e-3), ("argmin_params", 2e-3)):
            np.testing.assert_allclose(getattr(plan, k).numpy(), g[pre + k],
                                       rtol=1e-3, atol=tol, err_msg=pre + k)


# ----------------------------------------- the LUT, the fit and the eval

@pytest.fixture(scope="module")
def cut_lut(tmp_path_factory):
    """The cut LUT written by both packages' generators."""
    d = str(tmp_path_factory.mktemp("lut"))
    mp = pytest.MonkeyPatch()
    mp.chdir(d)
    mp.setattr(sys, "path", [ROOT] + sys.path)
    os.makedirs("j")
    os.makedirs("t")
    try:
        with jax.enable_x64(False):
            _run_script(_script("gen_clothoid_lut"),
                        CUT_GRID + ["--save_path", "j"], mp)
        tgen.main(CUT_GRID + ["--save_path", "t", "--device", "cpu"])
    finally:
        mp.undo()
    return (d, os.path.join(d, "j", "lut_allkappa.npz"),
            os.path.join(d, "t", "lut_allkappa.npz"))


def test_lut_matches_jax(cut_lut):
    _, j_path, t_path = cut_lut
    with np.load(j_path) as zj, np.load(t_path) as zt:
        assert sorted(zj.files) == sorted(zt.files) == [
            "lut", "tlut", "xlut", "ylut"]
        assert zt["lut"].shape == zj["lut"].shape == (11, 9, 9, 5)
        assert zt["lut"].dtype == zj["lut"].dtype == np.float32
        for k in ("xlut", "ylut", "tlut"):
            np.testing.assert_array_equal(zt[k], zj[k])
        np.testing.assert_allclose(zt["lut"], zj["lut"], rtol=1e-6,
                                   atol=TOL_F32["length"])


def test_choose_centers_with_probs_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    w = (1.0 + 2.0 * rng.exponential(size=3000)).astype(np.float32)
    lb = np.array([[-1, -1, -1], [0, -1, -1]], np.float64)
    ub = np.array([[0, 1, 1], [1, 1, 1]], np.float64)
    kw = dict(num_kernels=40, num_regions=2, seed=5, lb=lb, ub=ub,
              activation_idx=[0, 1, 2], input_scale=(1.0, 2.0, 0.5), probs=w)
    jc, js = jfit.choose_centers(x, **kw)
    tc, ts = tfit.choose_centers(x, device="cpu", **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x_dev, _, _ = tfit.device_table(x, chunk=1024, device="cpu")
    tc2, _ = tfit.choose_centers(x, x_dev=x_dev, **kw)
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc))


def _line(text, prefix):
    return [ln for ln in text.splitlines() if ln.strip().startswith(prefix)]


def _nums(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


def _train_both(recipe, monkeypatch, capfd):
    capfd.readouterr()
    with jax.enable_x64(False):
        _run_script(_script("train_clothoid"), recipe, monkeypatch)
    j_out = capfd.readouterr().out
    res = ttrain.main(recipe + ["--device", "cpu", "--out_dir", "out"])
    t_out = capfd.readouterr().out
    return j_out, res, t_out


def test_train_clothoid_and_eval_match_jax(cut_lut, monkeypatch, capfd):
    """Both trainers on the JAX package's cut LUT, then both evals: without
    IRLS the same centers bit for bit; with two IRLS rounds the printed
    endpoint errors of every round and the final probes (the rounds' center
    draws are weighted by each package's f32 endpoint errors, and
    ``argpartition`` orders a Gumbel top-k by its values, so the chosen
    rows' order may differ); then the eval's numbers."""
    from irbfn_tpu.train import load_model as jload

    d, j_path, _ = cut_lut
    monkeypatch.chdir(d)
    monkeypatch.setattr(sys, "path", [ROOT] + sys.path)
    recipe = ["--lut_path", j_path, "--run_name", "cut", "--num_x", "2",
              "--num_y", "2", "--num_t", "2", "--num_k", "24"]
    j_out, res, t_out = _train_both(recipe, monkeypatch, capfd)
    with jax.enable_x64(False):
        jmodel, jvars, jconfig = jload("configs/cut.yaml", "ckpts/cut")
    config = load_config("out/cut.json")
    assert config == jconfig
    want = params_from_jax(jax.tree.map(np.asarray, jvars), config)
    net = res["model"]
    for k in ("centers", "log_sigs"):
        assert torch.equal(net.state_dict()[k], want[k]), k
    # f32 grams, whose products XLA and the host BLAS sum in different
    # orders, of a system with a 1e-5 ridge (``tests/test_torch_fit.py``):
    # measured 0.4% apart in the probes
    (jl,), (tl,) = (_line(o, "spiral-param L1") for o in (j_out, t_out))
    np.testing.assert_allclose(_nums(tl)[:2], _nums(jl)[:2], rtol=1e-2,
                               atol=1e-4)

    j_out, res, t_out = _train_both(recipe + ["--error_reweight", "2"],
                                    monkeypatch, capfd)
    rounds = [_line(o, "IRLS round") for o in (j_out, t_out)]
    assert len(rounds[0]) == len(rounds[1]) == 2
    # the means (a tail is one row of 891): round 1 measures the fit above;
    # later rounds follow a draw whose rows may pair with other jitters
    # (measured: 1.8% apart in round 2 on this 891-row LUT)
    for rtol, a, b in zip((1e-2, 5e-2), *rounds):
        np.testing.assert_allclose(_nums(b)[0], _nums(a)[0], rtol=rtol,
                                   atol=1e-4)
    (jl,), (tl,) = (_line(o, "spiral-param L1") for o in (j_out, t_out))
    np.testing.assert_allclose(_nums(tl)[:2], _nums(jl)[:2], rtol=5e-2,
                               atol=1e-4)
    np.testing.assert_allclose([res["param_l1"], res["endpoint_l1"]],
                               _nums(tl)[:2], rtol=0.0, atol=1e-5)
    assert set(res["seconds"]) >= {"upload", "fit", "errors_1", "fit_1",
                                   "errors_2", "fit_2", "probes"}
    with jax.enable_x64(False):
        jmodel, jvars, jconfig = jload("configs/cut.yaml", "ckpts/cut")
    want = params_from_jax(jax.tree.map(np.asarray, jvars), config)
    net = res["model"]

    # both evals: the LUT's own entries, then the net with JAX's weights
    net.load_state_dict(want)
    save_checkpoint("out/cut_jax", net, step=0)
    for extra_j, extra_t in (([], []),
                             (["--config_f", "configs/cut.yaml", "--ckpt",
                               "ckpts/cut"],
                              ["--config_f", "out/cut.json", "--ckpt",
                               "out/cut_jax"])):
        capfd.readouterr()
        _run_script(_script("eval_lut_accuracy"),
                    ["--lut_path", j_path] + extra_j, monkeypatch)
        j_ev = capfd.readouterr().out
        got = teval.main(["--lut_path", j_path, "--device", "cpu"] + extra_t)
        t_ev = capfd.readouterr().out
        jl, tl = j_ev.splitlines(), t_ev.splitlines()
        assert len(jl) == len(tl) == 6
        assert tl[0] == jl[0]
        for a, b in zip(jl[1:], tl[1:]):
            # f32 forwards of two programs: 5e-4 relative on the means
            np.testing.assert_allclose(_nums(b), _nums(a), rtol=5e-3,
                                       atol=2e-6, err_msg=b)
        assert tl[-1] == jl[-1]  # the O(h^2) bound: the LUT's own numbers
        assert got["x_mean"] == pytest.approx(_nums(tl[1])[0], rel=1e-2)


def test_train_clothoid_resume_and_step_cap(cut_lut, tmp_path):
    _, _, t_path = cut_lut
    base = ["--lut_path", t_path, "--run_name", "r", "--num_x", "2",
            "--num_k", "12", "--device", "cpu", "--out_dir", str(tmp_path)]
    first = ttrain.main(base)
    w0 = first["model"].head_kernel.detach().clone()
    res = ttrain.main(base + ["--resume", "--finetune_epochs", "3",
                              "--finetune_steps", "2", "--batch", "64"])
    # two Adam steps from the checkpoint, not from a fit
    assert not torch.equal(res["model"].head_kernel.detach(), w0)
    assert res["param_l1"] == pytest.approx(first["param_l1"], rel=0.05)
    assert "finetune" in res["seconds"] and "fit" not in res["seconds"]


@pytest.mark.parametrize("seed", [0, 123])
def test_train_clothoid_shuffles_with_the_seed(seed, cut_lut, tmp_path,
                                               monkeypatch):
    """The JAX script hands ``train_epochs`` ``PRNGKey(seed)`` unsplit, so
    its batches follow ``seed`` itself; so do the port's."""
    _, _, t_path = cut_lut
    real, seen = ttrain.train_epochs, []

    def wrapper(*a, **kw):
        seen.append(kw["seed"])
        return real(*a, **kw)

    monkeypatch.setattr(ttrain, "train_epochs", wrapper)
    ttrain.main(["--lut_path", t_path, "--run_name", "s", "--num_x", "2",
                 "--num_k", "12", "--device", "cpu", "--out_dir",
                 str(tmp_path), "--seed", str(seed), "--finetune_epochs",
                 "1", "--finetune_steps", "1", "--batch", "64"])
    assert seen == [seed]
