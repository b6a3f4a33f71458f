"""The port's trainer vs the JAX package, on the CPU: the mirrors, the five
losses and their gradients, the Adam steps, ``train_epochs``, the checkpoint
files, the clustering copy and the flag groups.

Each loss is computed in f64 by both packages on the batches of
``tests/test_train.py`` with the same weights; value, parts and the gradient
with respect to every parameter agree to 1e-9. Five clipped Adam steps
leave the same weights to 1e-8.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irbfn_tpu import models as jmodels
from irbfn_tpu import train as jtrain
from irbfn_tpu.dynamics.params import f1tenth_params as jf1tenth
from irbfn_tpu.train import clustering as jclustering
from irbfn_tpu.utils import args as jargs
from irbfn_tpu_torch import models as tmodels
from irbfn_tpu_torch import train as ttrain
from irbfn_tpu_torch.train import clustering as tclustering
from irbfn_tpu_torch.utils import args as targs
from irbfn_tpu_torch.utils.metrics import MetricLogger

torch.set_num_threads(1)

TOL_LOSS = dict(rtol=1e-9, atol=1e-9)  # losses and gradients, f64
TOL_ADAM = dict(rtol=0.0, atol=1e-8)  # weights after five Adam steps, f64

FRENET = dict(in_features=8, num_kernels=8, basis_func="gaussian",
              num_regions=2, lower_bounds=[[-2.0, 0.0]],
              upper_bounds=[[0.0, 2.0]], dimension_ranges=[[0], [1]],
              activation_idx=[0], delta=[15.0])


def _batch(n=16, t=5, seed=0):
    """The batch of tests/test_train.py, in f64."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([
        rng.uniform(-0.5, 0.5, n), rng.uniform(-0.3, 0.3, n),
        rng.uniform(1, 7, n), rng.uniform(-1, 1, n), rng.uniform(3, 7, n),
        rng.uniform(-2, 2, n), rng.uniform(-0.5, 0.5, n),
        rng.uniform(-0.1, 0.1, n)])
    y = rng.uniform(-1, 1, (n, 2 * t))
    return x, y


def _pair(config, seed=0, in_features=8):
    """A flax model with f64 variables and the port's model with them."""
    jmodel = jmodels.from_config(config)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.ones((1, in_features)))
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * rng.standard_normal(a.shape), variables)
    net = tmodels.from_config(config, dtype=torch.float64, device="cpu")
    net.load_state_dict(ttrain.params_from_jax(variables, config))
    return jmodel, variables, net


def _apply(jmodel):
    return lambda p, x: jmodel.apply({"params": p["params"]}, x)


def _dyn():
    vec = np.array(jf1tenth(dtype=jnp.float64).to_vector())
    return jnp.asarray(vec), torch.from_numpy(vec)


def _compare_loss(jloss, tloss, config, x, y, extra=(), in_features=8,
                  dyn=True):
    jmodel, variables, net = _pair(config, in_features=in_features)
    dj, dt = _dyn() if dyn else (None, None)
    jextra = tuple(jnp.asarray(e) for e in extra)

    def lf(p):
        return jloss(_apply(jmodel), p, jnp.asarray(x), jnp.asarray(y),
                     *jextra, dj)

    (loss, aux), grads = jax.value_and_grad(lf, has_aux=True)(
        {"params": variables["params"]})
    tl, taux = tloss(net, torch.from_numpy(x), torch.from_numpy(y),
                     *(torch.from_numpy(e) for e in extra), dt)
    np.testing.assert_allclose(float(tl.detach()), float(loss), **TOL_LOSS)
    assert len(taux) == len(aux)
    for a, b in zip(taux, aux):
        np.testing.assert_allclose(float(a.detach()), float(b), **TOL_LOSS)
    tl.backward()
    want = ttrain.params_from_jax(jax.tree.map(np.asarray, grads), config)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **TOL_LOSS)
    return net


@pytest.mark.parametrize("head_mode", ["shared", "per_region"])
def test_torch_frenet_fullint_loss_and_gradients(head_mode):
    x, y = _batch()
    config = dict(FRENET, out_features=10, head_mode=head_mode)
    _compare_loss(jtrain.frenet_fullint_loss, ttrain.frenet_fullint_loss,
                  config, x, y)


def test_torch_frenet_oneint_loss_and_gradients():
    x, _ = _batch(seed=1)
    y = np.random.default_rng(2).uniform(-1, 1, (16, 2))
    config = dict(FRENET, out_features=2)
    _compare_loss(jtrain.frenet_oneint_loss, ttrain.frenet_oneint_loss,
                  config, x, y)
    # the x100 weight is inside the reported part
    _, _, net = _pair(config)
    loss, (pred, inte) = ttrain.frenet_oneint_loss(
        net, torch.from_numpy(x), torch.from_numpy(y), _dyn()[1])
    np.testing.assert_allclose(float(loss), float(pred) + float(inte),
                               rtol=1e-12)


def test_torch_cluster_fullint_loss_and_gradients():
    x, y = _batch(seed=3)
    ids = np.random.default_rng(0).integers(0, 4, 16)
    config = dict(model_class="ClusterWCRBFNet", in_features=8,
                  out_features=10, num_kernels=8, basis_func="gaussian",
                  num_regions=4)
    _compare_loss(jtrain.cluster_fullint_loss, ttrain.cluster_fullint_loss,
                  config, x, y, extra=(ids,))


def test_torch_cartesian_fullint_loss_and_gradients():
    rng = np.random.default_rng(5)
    n = 16
    x = np.column_stack([
        rng.uniform(1.0, 6.0, n), rng.uniform(0.5, 3.0, n),
        rng.uniform(-2.0, 2.0, n), rng.uniform(-1.0, 1.0, n),
        rng.uniform(1.0, 6.0, n), rng.uniform(-0.3, 0.3, n),
        rng.uniform(-1.0, 1.0, n)])
    y = rng.uniform(-2.0, 2.0, (n, 10))
    config = dict(FRENET, in_features=7, out_features=10,
                  lower_bounds=[[0.0, 3.0]], upper_bounds=[[3.0, 7.0]])
    _compare_loss(jtrain.cartesian_fullint_loss,
                  ttrain.cartesian_fullint_loss, config, x, y,
                  in_features=7)


def test_torch_clothoid_endpoint_loss_and_gradients():
    rng = np.random.default_rng(6)
    n = 16
    x = np.column_stack([rng.uniform(8, 20, n), rng.uniform(-4, 4, n),
                         rng.uniform(-0.8, 0.8, n)])
    y = np.column_stack([rng.uniform(-0.1, 0.1, (n, 4)),
                         rng.uniform(8, 22, n)])
    config = dict(FRENET, in_features=3, out_features=5,
                  lower_bounds=[[8.0, 14.0]], upper_bounds=[[14.0, 20.0]],
                  delta=[2.0])
    # a head bias that makes the predicted arc length positive
    jmodel, variables, net = _pair(config, in_features=3)
    from irbfn_tpu.train.trainer import clothoid_endpoint_loss as jloss

    variables["params"]["head"]["bias"][4] += 12.0
    net.load_state_dict(ttrain.params_from_jax(variables, config))

    def lf(p):
        return jloss(_apply(jmodel), p, jnp.asarray(x), jnp.asarray(y), None)

    (loss, aux), grads = jax.value_and_grad(lf, has_aux=True)(
        {"params": variables["params"]})
    tl, taux = ttrain.clothoid_endpoint_loss(net, torch.from_numpy(x),
                                             torch.from_numpy(y))
    np.testing.assert_allclose(float(tl.detach()), float(loss), **TOL_LOSS)
    for a, b in zip(taux, aux):
        np.testing.assert_allclose(float(a.detach()), float(b), **TOL_LOSS)
    tl.backward()
    want = ttrain.params_from_jax(jax.tree.map(np.asarray, grads), config)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **TOL_LOSS)


@pytest.mark.parametrize("max_grad_norm,decay_steps", [(1.0, None),
                                                       (0.05, 4)])
def test_torch_five_adam_steps_match_optax(max_grad_norm, decay_steps):
    """Five steps of frenet_fullint_loss in f64 through the JAX train step
    (optax clip_by_global_norm + adam, the cosine schedule in the second
    case, where the clip is active at every step) and through the port's
    Trainer leave the same weights and report the same losses."""
    x, y = _batch(32)
    config = dict(FRENET, out_features=10, head_mode="per_region")
    jmodel, variables, net = _pair(config)
    dj, dt = _dyn()
    lr = 1e-2
    state = jtrain.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.asarray(x), lr=lr,
        max_grad_norm=max_grad_norm, decay_steps=decay_steps).replace(
            params={"params": jax.tree.map(jnp.asarray,
                                           variables["params"])})
    state = state.replace(opt_state=state.tx.init(state.params))
    jstep = jtrain.make_train_step(jtrain.frenet_fullint_loss, dj,
                                   donate=False)
    trainer = ttrain.create_trainer(net, lr=lr, max_grad_norm=max_grad_norm,
                                    decay_steps=decay_steps)
    tstep = ttrain.make_train_step(ttrain.frenet_fullint_loss, dt)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(5):
        if max_grad_norm < 1.0:  # the clip must be active here
            g = jax.grad(lambda p: jtrain.frenet_fullint_loss(
                state.apply_fn, p, jnp.asarray(x), jnp.asarray(y), dj)[0])(
                    state.params)
            assert float(optax.global_norm(g)) > max_grad_norm
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y))
        tm = tstep(trainer, xt, yt)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss),
                                   **TOL_LOSS)
        assert tm.cluster_loss is None
    want = ttrain.params_from_jax(jax.tree.map(np.asarray, state.params),
                                  config)
    moved = 0.0
    start = ttrain.params_from_jax(variables, config)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   **TOL_ADAM)
        moved = max(moved, float((v - start[k]).abs().max()))
    assert moved > 1e-3  # the steps did move the weights
    assert trainer.step_count == 5


def test_torch_mirrors_and_region_spec_equal_jax():
    x, y = _batch(6)
    for exact in (True, False):
        for a, b in zip(ttrain.mirror_frenet_table(x, y, exact=exact),
                        jtrain.mirror_frenet_table(x, y, exact=exact)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    xc, yc = rng.normal(size=(6, 7)), rng.normal(size=(6, 10))
    for a, b in zip(ttrain.mirror_cartesian_table(xc, yc),
                    jtrain.mirror_cartesian_table(xc, yc)):
        np.testing.assert_array_equal(a, b)
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 7), np.linspace(0, 4, 5),
                                [2.0], indexing="ij"), -1).reshape(-1, 3)
    for splits, ov in (((2, 2, 1), 1), ((3, 1, 1), 2)):
        assert (ttrain.region_spec_from_table(grid, splits, ov)
                == jtrain.region_spec_from_table(grid, splits, ov))


def test_torch_train_epochs_draws_and_hooks():
    """The batches are gathered by numpy's permutation of the seed (the JAX
    package's draws for PRNGKey(seed)); log_fn fires every ``log_every``
    steps and at each epoch's last, checkpoint_fn every
    ``checkpoint_every`` epochs and at the end; the L1 loss falls."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    y = np.sin(2 * x[:, :2]).astype(np.float32)
    config = dict(FRENET, in_features=3, out_features=2,
                  lower_bounds=[[-1.0, 0.0]], upper_bounds=[[0.0, 1.0]])
    net = tmodels.from_config(config, device="cpu", seed=0)
    seen, logged, saved = [], [], []

    def spy_loss(model, xb, yb, dyn):
        seen.append(xb.clone())
        return ttrain.pred_l1_loss(model, xb, yb, dyn)

    trainer = ttrain.create_trainer(net, lr=1e-2, decay_steps=12)
    trainer, final = ttrain.train_epochs(
        trainer, ttrain.make_train_step(spy_loss, None), x, y,
        batch_size=16, epochs=3, seed=11,
        log_fn=lambda s, m: logged.append((s, float(m.loss))),
        checkpoint_fn=lambda t, e: saved.append((e, t.step_count)),
        checkpoint_every=2, log_every=3, device="cpu")
    np_rng = np.random.default_rng(11)
    for e in range(3):
        perm = np_rng.permutation(64).reshape(4, 16)
        for b in range(4):
            assert torch.equal(seen[4 * e + b], torch.from_numpy(x[perm[b]]))
    assert [s for s, _ in logged] == [0, 3, 4, 7, 8, 11]
    assert saved == [(0, 4), (2, 12), (2, 12)]
    assert trainer.step_count == 12
    assert abs(trainer.optimizer.param_groups[0]["lr"] - 1e-3) < 1e-12
    assert logged[-1][1] < logged[0][1] and np.isfinite(final)
    # a table smaller than one batch is one step an epoch
    small = ttrain.create_trainer(net)
    ttrain.train_epochs(small, ttrain.make_train_step(
        ttrain.pred_l1_loss, None), x[:5], y[:5], batch_size=16, epochs=2,
        seed=0, device="cpu")
    assert small.step_count == 2


@pytest.mark.parametrize("name", ["WCRBFNet", "DeeperWCRBFNet", "MLP",
                                  "ClusterWCRBFNet"])
def test_torch_checkpoint_round_trip_into_flax(name, tmp_path):
    """save_checkpoint from the port, load_model in the port, and the same
    npz loaded into flax: three equal forwards."""
    config = dict(FRENET, out_features=10, model_class=name,
                  input_scale=[1.0, 2.0, 0.5, 1.0, 1.0, 0.3, 1.0, 4.0])
    if name == "WCRBFNet":
        config["head_mode"] = "per_region"
    net = tmodels.from_config(config, dtype=torch.float64, device="cpu",
                              seed=3)
    with torch.no_grad():
        for p in net.parameters():  # biases and widths off zero
            p.add_(0.1 * torch.randn(p.shape, dtype=p.dtype,
                                     generator=torch.Generator()
                                     .manual_seed(1)))
    cfg_path = str(tmp_path / "run.json")
    ckpt_dir = str(tmp_path / "run")
    ttrain.save_config(cfg_path, dict(config,
                                      basis_func=tmodels.get_basis(
                                          "gaussian")))
    assert json.load(open(cfg_path))["basis_func"] == "gaussian"
    path = ttrain.save_checkpoint(ckpt_dir, net, step=0)
    assert path.endswith("step_0.npz")
    x, _ = _batch(9)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
        out = out[0] if isinstance(out, tuple) else out
        back, cfg2 = ttrain.load_model(cfg_path, ckpt_dir, device="cpu",
                                       dtype=torch.float64)
        out2 = back(torch.from_numpy(x))
        out2 = out2[0] if isinstance(out2, tuple) else out2
    assert cfg2 == json.load(open(cfg_path))
    assert torch.equal(out, out2)
    tree = ttrain.restore_params(ckpt_dir)
    jmodel = jmodels.from_config(cfg2)
    ref = jmodel.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    ref = ref[0] if isinstance(ref, tuple) else ref
    # (the fused op folds the global bias into the per-region biases, as if
    # the normalised gates summed to 1: they sum to S / (S + 1e-9))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.0, atol=1e-9)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8)))
    assert jax.tree.structure(tree) == jax.tree.structure(dict(init))


def test_torch_checkpoint_overwrites_and_keeps(tmp_path):
    """A step saved twice holds the second weights; ``keep`` bounds the
    history; restore_params takes the newest step or the one asked for."""
    net = tmodels.from_config(dict(FRENET, out_features=2), device="cpu",
                              seed=0)
    d = str(tmp_path / "ckpt")
    ttrain.save_checkpoint(d, net, step=0)
    with torch.no_grad():
        net.head_bias.add_(1.0)
    ttrain.save_checkpoint(d, net, step=0)
    np.testing.assert_array_equal(
        ttrain.restore_params(d)["params"]["head"]["bias"],
        net.head_bias.detach().numpy())
    for step in (1, 2, 3):
        with torch.no_grad():
            net.head_bias.add_(1.0)
        ttrain.save_checkpoint(d, net, step=step, keep=2)
    assert ttrain.checkpoint_steps(d) == [2, 3]
    assert ttrain.restore_params(d, step=2)["params"]["head"]["bias"][0] == 3.0
    assert ttrain.restore_params(d)["params"]["head"]["bias"][0] == 4.0
    with pytest.raises(FileNotFoundError):
        ttrain.restore_params(str(tmp_path / "empty"))


def test_torch_clustering_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    cons = (rng.uniform(size=(200, 6)) < 0.3).astype(np.float64)
    cons[rng.choice(200, 10, replace=False)] = -999.0
    inputs = rng.integers(0, 4, (200, 3)).astype(np.float64)
    for a, b in zip(tclustering.unique_activation_patterns(cons),
                    jclustering.unique_activation_patterns(cons)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tclustering.cluster_ids(cons, 5),
                                  jclustering.cluster_ids(cons, 5))
    for mode in ("mode", "mean"):
        np.testing.assert_array_equal(
            tclustering.cluster_centers(inputs, cons, 5, mode=mode),
            jclustering.cluster_centers(inputs, cons, 5, mode=mode))
    tp = tclustering.save_cluster_artifacts(str(tmp_path / "t.npz"), inputs,
                                            cons, 5)
    jp = jclustering.save_cluster_artifacts(str(tmp_path / "j.npz"), inputs,
                                            cons, 5)
    for a, b in zip(tp, jp):
        assert a.replace("/t_", "/j_") == b
        with np.load(a) as za, np.load(b) as zb:
            assert za.files == zb.files
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("group", ["add_train_args", "add_vehicle_args",
                                   "add_eval_args", "add_io_args"])
def test_torch_flag_groups_equal_jax(group):
    """Same flags, same defaults."""
    argv = ["--npz_path", "t.npz"] if group == "add_train_args" else []
    pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
    getattr(jargs, group)(pj)
    getattr(targs, group)(pt)
    assert vars(pt.parse_args(argv)) == vars(pj.parse_args(argv))


def test_torch_device_flags_and_metric_logger(tmp_path):
    p = targs.add_device_args(argparse.ArgumentParser())
    args = p.parse_args([])
    assert args.device is None and args.out_dir == "torch_runs"
    path = str(tmp_path / "logs" / "m.jsonl")
    log = MetricLogger(path=path, config={"a": 1})
    log.log({"loss": torch.tensor(0.5), "n": 3, "skip": None,
             "np": np.float32(2.0)}, step=7)
    log.close()
    rec = [json.loads(line) for line in open(path)]
    assert rec == [{"loss": 0.5, "n": 3.0, "np": 2.0, "step": 7}]
    MetricLogger().log({"loss": 1.0})  # no file: nothing to write


def test_torch_train_golden_f64():
    """The committed trainer fixture of the flagship net (JAX's f64
    frenet_fullint_loss, its gradient and five Adam steps on a seeded batch,
    ``scripts/export_torch_ckpt.py --train_golden``) against the port in
    f64 on the same batch, to 1e-8."""
    import os

    asset = os.path.join("irbfn_tpu_torch", "assets", "frenet_wide_pr1")
    with np.load(asset + "_train_golden.npz") as z:
        g = {k: z[k] for k in z.files}
    net, _ = ttrain.load_model(asset + ".json", asset + ".npz",
                               dtype=torch.float64, device="cpu")
    x = torch.from_numpy(g["x"].astype(np.float64))
    y, dyn = torch.from_numpy(g["y"]), torch.from_numpy(g["dyn"])
    tol = dict(rtol=1e-8, atol=1e-8)
    loss, (pred, inte) = ttrain.frenet_fullint_loss(net, x, y, dyn)
    for got, key in ((loss, "loss"), (pred, "pred_loss"), (inte, "int_loss")):
        np.testing.assert_allclose(float(got.detach()), float(g[key]), **tol)
    loss.backward()
    for name, p in net.named_parameters():
        flat = p.grad.numpy().reshape(-1)
        np.testing.assert_allclose(np.linalg.norm(flat),
                                   g[f"grad_norm_{name}"], err_msg=name,
                                   **tol)
        np.testing.assert_allclose(flat[::int(g[f"grad_stride_{name}"])],
                                   g[f"grad_sample_{name}"], err_msg=name,
                                   **tol)
    trainer = ttrain.create_trainer(net, lr=float(g["lr"]),
                                    max_grad_norm=float(g["max_grad_norm"]))
    step = ttrain.make_train_step(ttrain.frenet_fullint_loss, dyn)
    losses = [float(step(trainer, x, y).loss) for _ in g["step_losses"]]
    np.testing.assert_allclose(losses, g["step_losses"], **tol)
