"""The port's closed-form fit vs the JAX package, on the CPU, and the goal-net
chain (lattice -> fit -> eval -> checkpoint into flax) run by both packages.

Tables: a 9x9x9 clothoid lattice solved by the JAX package (as
``tests/test_end_to_end.py`` makes it), a small goal-MPC lattice solved by
both packages, and synthetic grids. For one table and seed the port picks
the same centers as JAX bit for bit; f64 fits agree to 1e-8 relative in the
weights and 1e-9 in the predictions; f32 predictions to the tolerances of
``tests/test_end_to_end.py``.
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

from irbfn_tpu import models as jmodels
from irbfn_tpu.models import fit as jfit
from irbfn_tpu.models import get_basis as jget_basis
from irbfn_tpu.parallel import GridSpec, build_lattice
from irbfn_tpu.solvers.clothoid import solve_g1_lattice
from irbfn_tpu_torch import train as ttrain
from irbfn_tpu_torch.models import fit as tfit
from irbfn_tpu_torch.models import overlapping_segments
from irbfn_tpu_torch.parallel import gen_goal_mpc_table as tgen
from irbfn_tpu_torch.train import eval_goal_mpc as teval
from irbfn_tpu_torch.train import eval_offline as teval_offline
from irbfn_tpu_torch.train import train_frenet as ttrain_frenet
from irbfn_tpu_torch.train import train_goal_mpc as ttrain_goal

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL_W_REL = 1e-8  # f64 weights, relative to the largest weight
TOL_PRED = 1e-9  # f64 predictions, relative to the largest output
TINY_GRID = ["--d_x_goal", "1.3", "--d_y_goal", "1.0", "--d_t_goal", "1.57",
             "--d_v_car", "4.5", "--d_v_goal", "4.5"]


@pytest.fixture(scope="module")
def clothoid_table():
    grid = (GridSpec("x", 8.0, 20.0, 9), GridSpec("y", -4.0, 4.0, 9),
            GridSpec("theta", -0.8, 0.8, 9))
    goals = build_lattice(grid, dtype=np.float64)
    return goals, np.asarray(solve_g1_lattice(jnp.asarray(goals)))


def _step_table():
    """The 41x9 grid with a jump in dim 0 of tests/test_end_to_end.py."""
    xs = np.linspace(-1.0, 1.0, 41)
    zs = np.linspace(-1.0, 1.0, 9)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    x = np.stack([gx.reshape(-1), gz.reshape(-1)], -1).astype(np.float32)
    y = (np.where(x[:, :1] > 0, 2.0, -2.0) + 0.3 * x[:, 1:]).astype(
        np.float32)
    lo, hi = overlapping_segments(xs, 2, num_overlap=1)
    lb, ub = np.asarray([[v] for v in lo]), np.asarray([[v] for v in hi])
    return x, y, lb, ub, np.asarray([4.0 / (xs[1] - xs[0])])


def _same_centers(jres, tres):
    for j, t in zip(jres, tres):
        assert np.asarray(j).dtype == t.numpy().dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", ["global", "boxes", "boxes-scaled",
                                  "small-pool", "probs"])
def test_torch_choose_centers_bitwise(case, clothoid_table):
    """The same centers and log-widths as JAX, bit for bit: global sampling,
    per-region boxes (f32 table against f64 bounds, with the 1e-9 slack),
    an anisotropic metric, a region with fewer rows than kernels (sampling
    with replacement), and Gumbel top-k importance sampling."""
    goals, _ = clothoid_table
    x32 = goals.astype(np.float32)
    lb = np.asarray([[8.0, -4.0], [14.0, -4.0], [8.0, 0.0], [14.0, 0.0]])
    ub = np.asarray([[14.0, 0.0], [20.0, 0.0], [14.0, 4.0], [20.0, 4.0]])
    kw = dict(num_kernels=16, num_regions=4, seed=3)
    if case == "global":
        x, kw = goals, dict(num_kernels=32, num_regions=2, seed=0)
    elif case == "boxes":
        x, kw = x32, dict(kw, lb=lb, ub=ub, activation_idx=(0, 1))
    elif case == "boxes-scaled":
        x, kw = x32, dict(kw, lb=lb, ub=ub, activation_idx=(0, 1),
                          input_scale=(0.3, 0.5, 2.0), width_neighbors=2)
    elif case == "small-pool":
        x, kw = x32[:60], dict(kw, lb=lb, ub=ub, activation_idx=(0, 1))
    else:
        probs = np.random.default_rng(0).uniform(0.05, 1.0, len(x32))
        x, kw = x32, dict(kw, lb=lb, ub=ub, activation_idx=(0, 1),
                          probs=probs)
    jres = jfit.choose_centers(jnp.asarray(x), **kw)
    _same_centers(jres, tfit.choose_centers(x, device="cpu", **kw))
    # with the table resident (the box tests and the gather on the device)
    x_dev, _, _ = tfit.device_table(x, chunk=64, device="cpu")
    if x.dtype == np.float32:
        _same_centers(jres, tfit.choose_centers(x, x_dev=x_dev, **kw))
    np.testing.assert_array_equal(
        tfit.widths_from_centers(np.asarray(jres[0]),
                                 input_scale=kw.get("input_scale")),
        jfit.widths_from_centers(np.asarray(jres[0]),
                                 input_scale=kw.get("input_scale")))
    np.testing.assert_array_equal(tfit.data_scale(x), jfit.data_scale(x))


@pytest.mark.parametrize("mode", ["shared", "per_region"])
def test_torch_fit_direct_f64_matches_jax(mode, clothoid_table):
    goals, params = clothoid_table
    c, ls = jfit.choose_centers(jnp.asarray(goals), num_kernels=24,
                                num_regions=2, seed=1)
    lb, ub = np.asarray([[8.0], [14.0]]), np.asarray([[14.0], [20.0]])
    delta = np.asarray([5.0])
    w = np.random.default_rng(0).uniform(0.1, 1.0, len(goals))
    for sw in (None, w):
        jf = jfit.fit_direct(jnp.asarray(goals), jnp.asarray(params), c, ls,
                             jnp.asarray(lb), jnp.asarray(ub),
                             jnp.asarray(delta), (0,), jget_basis("gaussian"),
                             reg=1e-8, mode=mode, chunk=256,
                             input_scale=(0.3, 0.5, 2.0), sample_weight=sw)
        tf = tfit.fit_direct(goals, params, np.asarray(c), np.asarray(ls),
                             lb, ub, delta, (0,), "gaussian", reg=1e-8,
                             mode=mode, chunk=256,
                             input_scale=(0.3, 0.5, 2.0), sample_weight=sw,
                             device="cpu")
        assert tf.weights.dtype == torch.float64 and tf.mode == mode
        assert tf.input_scale == jf.input_scale
        # the full per_region design is collinear by construction (its
        # gamma columns sum to the constant column), so only the ridge
        # makes the system regular and the weights are defined to ~1e-7
        tol = TOL_W_REL if mode == "shared" else 1e-6
        assert _rel(tf.weights.numpy(), np.asarray(jf.weights)) <= tol
        assert _rel(tf.bias.numpy(), np.asarray(jf.bias)) <= tol
        jp = jf.predict(jnp.asarray(goals), jnp.asarray(lb), jnp.asarray(ub),
                        jnp.asarray(delta), (0,), jget_basis("gaussian"))
        tp = tf.predict(goals, lb, ub, delta, (0,), "gaussian")
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0.0,
                                   atol=TOL_PRED * float(np.abs(jp).max()))
    # the features themselves, both layouts
    feats = tfit.rbf_features(torch.from_numpy(goals), np.asarray(c),
                              np.asarray(ls), lb, ub, delta, (0,),
                              "gaussian", mode=mode)
    ref = jfit.rbf_features(jnp.asarray(goals), c, ls, jnp.asarray(lb),
                            jnp.asarray(ub), jnp.asarray(delta), (0,),
                            jget_basis("gaussian"), mode=mode)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), rtol=0.0,
                               atol=1e-12)


def test_torch_fit_direct_f32_interpolates(clothoid_table):
    """The f32 single-region fit of tests/test_end_to_end.py::
    test_direct_cholesky_fit_interpolates, with its limits, and close to
    JAX's f32 fit of the same table."""
    from irbfn_tpu_torch.dynamics import integrate_endpoint_gl
    from irbfn_tpu_torch.sim.track import wrap_angle

    goals, params = clothoid_table
    x, y = goals.astype(np.float32), params.astype(np.float32)
    c, ls = tfit.choose_centers(x, num_kernels=128, num_regions=1, seed=0,
                                device="cpu")
    lb = np.asarray([[goals[:, 0].min() - 1.0]])
    ub = np.asarray([[goals[:, 0].max() + 1.0]])
    delta = np.asarray([5.0])
    # reg at its default 1e-5: what an f32 gram needs (the JAX test's 1e-8
    # is for its f64 table)
    fit = tfit.fit_direct(x, y, c, ls, lb, ub, delta, (0,), "gaussian",
                          chunk=1024, device="cpu")
    assert fit.weights.dtype == torch.float32
    pred = fit.predict(x, lb, ub, delta, (0,), "gaussian")
    assert float((pred - torch.from_numpy(y)).abs().mean()) < 0.02
    end = integrate_endpoint_gl(pred)
    pos_err = np.hypot((end[:, 0] - torch.from_numpy(x[:, 0])).numpy(),
                       (end[:, 1] - torch.from_numpy(x[:, 1])).numpy())
    th_err = wrap_angle(end[:, 2] - torch.from_numpy(x[:, 2])).abs().numpy()
    assert np.median(pos_err) < 0.2 and np.median(th_err) < 0.05
    with jax.enable_x64(False):
        jf = jfit.fit_direct(jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(c.numpy()), jnp.asarray(ls.numpy()),
                             jnp.asarray(lb, jnp.float32),
                             jnp.asarray(ub, jnp.float32),
                             jnp.asarray(delta, jnp.float32), (0,),
                             jget_basis("gaussian"), chunk=1024)
        jp = np.asarray(jf.predict(jnp.asarray(x),
                                   jnp.asarray(lb, jnp.float32),
                                   jnp.asarray(ub, jnp.float32),
                                   jnp.asarray(delta, jnp.float32), (0,),
                                   jget_basis("gaussian")))
    # two f32 fits of one ill-conditioned gram (measured: 5.9e-4 mean,
    # 1.5e-2 at most, against a fit error of 9.7e-3)
    assert float(np.abs(pred.numpy() - jp).mean()) < 2e-3
    assert float(np.abs(pred.numpy() - jp).max()) < 5e-2


@pytest.mark.parametrize("weighted", [False, True])
def test_torch_fit_per_region_f64_matches_jax(weighted):
    x, y, lb, ub, delta = _step_table()
    x, y = x.astype(np.float64), y.astype(np.float64)
    c, ls = jfit.choose_centers(jnp.asarray(x), 24, 2, seed=1,
                                lb=jnp.asarray(lb), ub=jnp.asarray(ub),
                                activation_idx=(0,))
    sw = (np.random.default_rng(1).uniform(0.05, 1.0, len(x))
          if weighted else None)
    jf = jfit.fit_per_region(x, y, c, ls, jnp.asarray(lb), jnp.asarray(ub),
                             jnp.asarray(delta), (0,),
                             jget_basis("gaussian"), chunk=100,
                             sample_weight=sw)
    tf = tfit.fit_per_region(x, y, np.asarray(c), np.asarray(ls), lb, ub,
                             delta, (0,), "gaussian", chunk=100,
                             sample_weight=sw, device="cpu")
    R, K = 2, 24
    assert tf.weights.shape == (R * K + R, 1) and tf.mode == "per_region"
    assert float(tf.bias.abs().sum()) == 0.0  # the biases are rows R*K + r
    assert _rel(tf.weights.numpy(), np.asarray(jf.weights)) <= TOL_W_REL
    jp = jf.predict(jnp.asarray(x), jnp.asarray(lb), jnp.asarray(ub),
                    jnp.asarray(delta), (0,), jget_basis("gaussian"))
    tp = tf.predict(x, lb, ub, delta, (0,), "gaussian")
    # (the weights are stored in f32 by both packages)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0.0,
                               atol=TOL_PRED * float(np.abs(jp).max()))


def test_torch_fit_per_region_loads_into_the_model_and_beats_shared():
    """tests/test_end_to_end.py::test_per_region_fit_matches_model_and_
    beats_shared in f32, with its limits; the fitted weights installed into
    the port's WCRBFNet and, through a checkpoint, into flax."""
    x, y, lb, ub, delta = _step_table()
    c, ls = tfit.choose_centers(x, 24, 2, seed=1, lb=lb, ub=ub,
                                activation_idx=(0,), device="cpu")
    fit_pr = tfit.fit_per_region(x, y, c, ls, lb, ub, delta, (0,),
                                 "gaussian", chunk=1024, device="cpu")
    fit_sh = tfit.fit_direct(x, y, c, ls, lb, ub, delta, (0,), "gaussian",
                             chunk=1024, device="cpu")
    pred_pr = fit_pr.predict(x, lb, ub, delta, (0,), "gaussian").numpy()
    pred_sh = fit_sh.predict(x, lb, ub, delta, (0,), "gaussian").numpy()
    err_pr, err_sh = np.abs(pred_pr - y), np.abs(pred_sh - y)
    assert err_pr.mean() < err_sh.mean()
    away = np.abs(x[:, 0]) >= 0.2
    assert err_pr[away].mean() < 0.15
    assert err_pr[away].mean() < 0.7 * err_sh[away].mean()

    xs = np.linspace(-1.0, 1.0, 41)
    lo, hi = overlapping_segments(xs, 2, num_overlap=1)
    config = dict(model_class="WCRBFNet", in_features=2, out_features=1,
                  num_kernels=24, basis_func="gaussian", num_regions=2,
                  lower_bounds=[lo], upper_bounds=[hi],
                  dimension_ranges=[[0], [1]], activation_idx=[0],
                  delta=[float(delta[0])], head_mode="per_region")
    from irbfn_tpu_torch.models import from_config

    net = tfit.install_fit(from_config(config, device="cpu"), fit_pr)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, pred_pr, rtol=1e-4, atol=1e-4)
    tree = ttrain.params_to_jax(net.state_dict(), config)
    with jax.enable_x64(False):
        ref = jmodels.from_config(config).apply(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_torch_tube_weights_and_weighted_fit():
    """tests/test_end_to_end.py::test_tube_weights_and_weighted_fit, and the
    weights against JAX's."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(4000, 2)).astype(np.float32)
    tube = np.stack([np.linspace(-1, 1, 200),
                     np.zeros(200)], -1).astype(np.float32)
    w = tfit.tube_weights(x, tube, bandwidth=0.1, floor=0.05, chunk=1024,
                          device="cpu")
    assert w.shape == (4000,)
    near, far = np.abs(x[:, 1]) < 0.02, np.abs(x[:, 1]) > 0.6
    assert w[near].min() > 0.5 and w[far].max() < 0.1
    with jax.enable_x64(False):
        wj = jfit.tube_weights(x, tube, bandwidth=0.1, floor=0.05,
                               chunk=1024)
        wj_scaled = jfit.tube_weights(x, np.repeat(tube, 20, axis=0),
                                      input_scale=(2.0, 0.5), max_tube=256,
                                      seed=4)
    np.testing.assert_allclose(w, wj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tfit.tube_weights(x, np.repeat(tube, 20, axis=0),
                          input_scale=(2.0, 0.5), max_tube=256, seed=4,
                          device="cpu"), wj_scaled, rtol=1e-5, atol=1e-6)

    y = np.sin(6 * x[:, :1]) * np.cos(3 * x[:, 1:]).astype(np.float32)
    lb, ub, delta = np.asarray([[-1.5]]), np.asarray([[1.5]]), [5.0]
    c, ls = tfit.choose_centers(x, num_kernels=32, num_regions=1, seed=0,
                                probs=w, device="cpu")
    fit_w = tfit.fit_direct(x, y, c, ls, lb, ub, delta, (0,), "gaussian",
                            chunk=1024, sample_weight=w, device="cpu")
    fit_u = tfit.fit_direct(x, y, c, ls, lb, ub, delta, (0,), "gaussian",
                            chunk=1024, device="cpu")
    err = [float(np.abs(f.predict(x[near], lb, ub, delta, (0,),
                                  "gaussian").numpy() - y[near]).mean())
           for f in (fit_w, fit_u)]
    assert err[0] < err[1], err


def test_torch_device_resident_fit_matches_host_path():
    """tests/test_end_to_end.py::test_device_resident_fit_matches_host_path:
    the resident table (box tests and gathers on the device) against the
    host path (numpy's box test, rows uploaded per chunk). Both sum the
    same chunks in f64, so here even the weights agree."""
    x, y, lb, ub, delta = _step_table()
    c, ls = tfit.choose_centers(x, 24, 2, seed=1, lb=lb, ub=ub,
                                activation_idx=(0,), device="cpu")
    tube = x[np.abs(x[:, 1]) < 0.1]
    w = tfit.tube_weights(x, tube, bandwidth=0.2, floor=0.05, chunk=64,
                          device="cpu")
    x_dev, y_dev, n = tfit.device_table(x, y, chunk=64, device="cpu")
    assert n == len(x) and x_dev.shape[0] % 64 == 0
    assert float(x_dev[n:].abs().sum()) == 0.0
    w2 = tfit.tube_weights(x, tube, bandwidth=0.2, floor=0.05, chunk=64,
                           x_dev=x_dev)
    np.testing.assert_allclose(w, w2, rtol=1e-5, atol=1e-6)
    timings = {}
    f_host = tfit.fit_per_region(x, y, c, ls, lb, ub, delta, (0,),
                                 "gaussian", chunk=64, sample_weight=w,
                                 device="cpu")
    f_dev = tfit.fit_per_region(x, y, c, ls, lb, ub, delta, (0,),
                                "gaussian", chunk=64, sample_weight=w,
                                x_dev=x_dev, y_dev=y_dev, timings=timings)
    assert torch.equal(f_dev.weights, f_host.weights)
    p_host = f_host.predict(x, lb, ub, delta, (0,), "gaussian").numpy()
    p_dev = f_dev.predict(x, lb, ub, delta, (0,), "gaussian").numpy()
    np.testing.assert_allclose(p_dev, p_host, atol=0.05)
    assert float(np.abs(p_dev - y).mean()) < 0.5
    assert set(timings) == {"mask", "gram", "solve", "row_visits"}
    # the regions overlap: rows near the seam are visited twice
    assert len(x) < timings["row_visits"] < 2 * len(x)


# ------------------------------------------------------------- the chain

def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__ + ".py"] + argv)
    mod.main()


def _mae_line(text, prefix):
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    return [float(v) for v in re.findall(r"MAE (-?\d+\.\d+)", line)], line


def test_torch_goal_net_chain_matches_jax(tmp_path, monkeypatch, capfd):
    """A tiny goal lattice solved by both packages, then train_goal_mpc and
    eval_goal_mpc run by both on one table: the same centers, weights and
    printed MAEs to tolerance, and the port's checkpoint loaded into flax
    gives the port's forward."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", [ROOT] + sys.path)
    os.makedirs("data_j")
    os.makedirs("data_t")
    with jax.enable_x64(False):
        _run_script(_script("gen_goal_mpc_table"),
                    TINY_GRID + ["--save_path", "data_j"], monkeypatch)
    t_path = tgen.main(TINY_GRID + ["--save_path", "data_t", "--device",
                                    "cpu"])
    j_path = os.path.join("data_j", os.path.basename(t_path))
    with np.load(j_path) as zj, np.load(t_path) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        n_rows = zj["inputs"].shape[0]
        assert n_rows == 3 * 5 * 5 * 5 * 3
        for k in ("inputs", "valid", "lows", "highs", "nums", "dims"):
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        # two f32 ADMM solves: speed to 2.5e-5, steer to 5e-4 (the plan's
        # summation-order noise, tests/test_torch_goal_mpc.py)
        np.testing.assert_allclose(zt["outputs"][:, 0], zj["outputs"][:, 0],
                                   rtol=0.0, atol=2.5e-5)
        np.testing.assert_allclose(zt["outputs"][:, 1], zj["outputs"][:, 1],
                                   rtol=0.0, atol=5e-4)

    # both trainers on the JAX package's table
    recipe = ["--npz_path", j_path, "--run_name", "tiny", "--num_k", "24",
              "--num_v_car", "2", "--num_x_goal", "2"]
    capfd.readouterr()
    with jax.enable_x64(False):
        _run_script(_script("train_goal_mpc"), recipe, monkeypatch)
    j_out = capfd.readouterr().out
    res = ttrain_goal.main(recipe + ["--device", "cpu", "--out_dir", "out"])
    t_out = capfd.readouterr().out

    from irbfn_tpu.train import load_model as jload_model

    with jax.enable_x64(False):
        jmodel, jvars, jconfig = jload_model("configs/tiny.yaml",
                                             "ckpts/tiny")
    jvars = jax.tree.map(np.asarray, jvars)
    config = ttrain.load_config("out/tiny.json")
    assert config == jconfig
    net = res["model"]
    want = ttrain.params_from_jax(jvars, config)
    for k in ("centers", "log_sigs"):  # the same draws, bit for bit
        assert torch.equal(net.state_dict()[k], want[k]), k
    # the weights: f32 grams (whose products XLA and the host BLAS sum in
    # different orders) of a system with a 1e-5 ridge. They are held through
    # what they predict, on every row of the table
    with np.load(j_path) as z:
        x_all = z["inputs"]
    jnet = ttrain.load_model("out/tiny.json", "out/tiny", device="cpu")[0]
    jnet.load_state_dict(want)
    with torch.no_grad():
        d = (net(torch.from_numpy(x_all))
             - jnet(torch.from_numpy(x_all))).abs().numpy()
    # (measured: speed 1.4e-3 mean and 8.7e-3 at most, steer 2.6e-4 and
    # 1.5e-3, where the fit's own MAE is ~0.1 m/s and ~0.03 rad)
    assert d.mean() <= 3e-3 and d.max() <= 2e-2
    (j_mae, j_line), (t_mae, t_line) = (_mae_line(o, "speed MAE")
                                        for o in (j_out, t_out))
    assert j_line.split("(")[1] == t_line.split("(")[1]  # the same rows
    np.testing.assert_allclose(t_mae, j_mae, rtol=0.0, atol=1e-4)
    np.testing.assert_allclose(res["mae"], t_mae, rtol=0.0, atol=5e-5)

    # the port's weights in flax: the port's checkpoint -> the flax tree
    tree = ttrain.restore_params("out/tiny")
    with np.load(j_path) as z:
        x = z["inputs"][::7]
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    with jax.enable_x64(False):
        ref = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=2e-4)

    # with JAX's weights in the port, the printed MAE is the same to 1e-6
    net.load_state_dict(want)
    mae, _ = ttrain_goal.strided_mae(net, res["x_dev"], res["y_dev"],
                                     res["n_rows"])
    np.testing.assert_allclose(mae, j_mae, rtol=0.0, atol=5e-5 + 1e-6)

    # both evals on the JAX checkpoint's weights, saved by the port
    ttrain.save_checkpoint("out/tiny_jax", net, step=0)
    ev = ["--npz_path", j_path, "--n_offgrid", "256"]
    capfd.readouterr()
    with jax.enable_x64(False):
        _run_script(_script("eval_goal_mpc"),
                    ev + ["--config_f", "configs/tiny.yaml", "--ckpt",
                          "ckpts/tiny"], monkeypatch)
    j_out = capfd.readouterr().out
    got = teval.main(ev + ["--config_f", "out/tiny.json", "--ckpt",
                           "out/tiny_jax", "--device", "cpu"])
    t_out = capfd.readouterr().out
    for prefix, key in (("table:", "table_mae"), ("off-grid:",
                                                  "offgrid_mae")):
        (j_mae, j_line), (t_mae, t_line) = (_mae_line(o, prefix)
                                            for o in (j_out, t_out))
        assert j_line.split("(")[1] == t_line.split("(")[1], prefix
        np.testing.assert_allclose(t_mae, j_mae, rtol=0.0, atol=1e-4)
        np.testing.assert_allclose(got[key], t_mae, rtol=0.0, atol=5e-5)


def test_torch_train_frenet_and_eval_offline(tmp_path, capfd):
    """The Frenet entry points on a synthetic table ((N, T, 2) controls with
    -999 rows): the direct fit, its checkpoint before the probe, the probe's
    L1 equal to eval_offline's control L1 of the reloaded run, a fine-tune
    epoch, and the other model classes' branches."""
    rng = np.random.default_rng(0)
    axes = [np.linspace(-0.4, 0.4, 3), np.linspace(-0.2, 0.2, 2),
            np.linspace(2.0, 6.0, 3), [0.0], np.linspace(3.0, 6.0, 2),
            np.linspace(-1.0, 1.0, 2), np.linspace(-0.3, 0.3, 3),
            np.linspace(-0.1, 0.1, 2)]
    inputs = np.stack([m.reshape(-1) for m in np.meshgrid(
        *axes, indexing="ij")], -1).astype(np.float32)
    n = inputs.shape[0]
    accel = np.tanh(inputs[:, 4:5] - inputs[:, 2:3]) * np.linspace(1, .5, 5)
    sv = (-inputs[:, 0:1] - inputs[:, 6:7]) * np.linspace(1, .2, 5)
    outputs = np.stack([accel, sv], axis=-1).astype(np.float32)  # (N, T, 2)
    bad = rng.choice(n, 9, replace=False)
    outputs[bad] = -999.0
    npz = str(tmp_path / "frenet_table.npz")
    np.savez(npz, inputs=inputs, outputs=outputs)
    ids = rng.integers(0, 4, n)
    np.savez(str(tmp_path / "frenet_table_3_cluster_ids.npz"),
             cluster_int_ids=ids)
    out_dir = str(tmp_path / "runs")
    base = ["--npz_path", npz, "--device", "cpu", "--out_dir", out_dir,
            "--num_k", "16", "--seed", "0"]

    res = ttrain_frenet.main(base + [
        "--run_name", "fit", "--mirror_data", "--direct_fit", "--fit_mode",
        "per_region", "--num_ey", "2", "--finetune_epochs", "1",
        "--batch_size", "128", "--lr", "1e-4"])
    text = capfd.readouterr().out
    assert f"{n - 9:,} feasible rows" in text
    assert text.index("checkpoint at") < text.index("control L1")
    assert ttrain.checkpoint_steps(res["ckpt_dir"]) == [0, 1]
    assert np.isfinite(res["final_loss"]) and res["fit_l1"] < 0.1
    # step 0 is the fit: its offline eval prints the probe's L1
    cfg = os.path.join(out_dir, "fit.json")
    step0 = os.path.join(res["ckpt_dir"], "step_0.npz")
    ev = teval_offline.main(["--config_f", cfg, "--ckpt", step0,
                             "--npz_path", npz, "--mirror", "--device",
                             "cpu", "--chunk", "100"])
    text = capfd.readouterr().out
    assert "control L1:" in text and "final state: ey MAE" in text
    np.testing.assert_allclose(ev["control_l1"], res["fit_l1"], rtol=1e-4)
    assert np.isfinite(ev["picks"]).all()

    for flags, cls in ((["--deeper"], "DeeperWCRBFNet"),
                       (["--mlp"], "MLP"),
                       (["--use_cluster", "--num_clusters", "3"],
                        "ClusterWCRBFNet"),
                       (["--only_onestep"], "WCRBFNet")):
        res = ttrain_frenet.main(base + flags + [
            "--run_name", cls + flags[0], "--train_epochs", "2",
            "--batch_size", "64"])
        assert type(res["model"]).__name__ == cls
        assert np.isfinite(res["final_loss"])
        assert ttrain.checkpoint_steps(res["ckpt_dir"]) == [1, 2]
        model, config = ttrain.load_model(
            os.path.join(out_dir, f"{cls + flags[0]}.json"),
            res["ckpt_dir"], device="cpu")
        assert config["model_class"] == cls
        for k, v in res["model"].state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(SystemExit, match="incompatible"):
        ttrain_frenet.main(base + ["--use_cluster", "--mirror_data"])
