"""The port's expert-parallel (region-sharded) WCRBF nets and its DP x EP
train step vs the replicated port and the JAX package.

Eight gloo ranks (one spawn, ``parallel/launch.py``) run every case of
``parallel/rank_checks.py`` at the shape of ``tests/test_expert_parallel.py``
(8 regions, K=16, a batch of 32): ``WCRBFNet`` with a shared head and with
per-region heads (and an input scale), ``DeeperWCRBFNet`` and
``ClusterWCRBFNet``, all from one set of JAX-initialised weights.

- Forward, expert in {2, 4, 8}: every rank's output, through the fused op
  (on the CPU its plain version in the partial mode, the regions' sums and
  gate sum all-reduced before the divide) and through the module path,
  against the replicated port at 2e-6 in f32 (JAX's own sharded-vs-
  replicated tolerance) and against JAX's sharded ``model.apply`` at 1e-10
  in f64. Per-region heads through the fused op are held against the
  replicated fused op at 1e-10 in f64 instead: the fused op folds the
  head's bias into every region's bias, as JAX's Pallas wrapper does
  (``irbfn_tpu/ops/pallas_rbf.py:236-240``), which is exact only where the
  normalised gates sum to 1, and most rows of this batch lie outside every
  region (gate sums down to 1e-87 in f64), where ``model.apply`` keeps the
  bias and the fused op does not. On those rows the module path of the
  replicated port is itself 6.2e-9 from JAX: the normalisation divides by
  the gate sum, and ``tanh(t) + 1`` deep in the tail keeps only a few bits
  of a tanh that the two packages round one ulp apart. The per-region module
  path is held at 1e-10 on the rows whose gate sum is at least 1e-6 and at
  1e-8 on the others.
- Train step, data x expert in {4x2, 2x4, 1x8}, f64: the loss within 1e-5
  relative of the replicated port step's and of JAX's sharded step's; every
  parameter's all-reduced gradient within 1e-5 relative of the replicated
  step's ``.grad`` (an error of a constant factor would pass a comparison
  of the weights after one Adam step, which is nearly lr * sign(g)); the
  clip's global norm equal to the replicated one's; and the gradients
  before the clip against JAX's gradient of the sharded loss.
- ``train_epochs`` on the mesh (two epochs of two steps, the shared-head
  net and the cluster net with its labels): the last epoch's mean loss and
  every parameter against the replicated ``train_epochs`` to 1e-10 in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu import models as jmodels
from irbfn_tpu.dynamics.params import fullscale_params as jfullscale
from irbfn_tpu.parallel.mesh import data_sharding as jdata_sharding
from irbfn_tpu.parallel.mesh import make_mesh as jmake_mesh
from irbfn_tpu.parallel.mesh import shard_params as jshard_params
from irbfn_tpu.train import trainer as jtrainer
from irbfn_tpu_torch import models as tmodels
from irbfn_tpu_torch.dynamics.params import fullscale_params
from irbfn_tpu_torch.ops.rbf import box_gate as tbox_gate
from irbfn_tpu_torch.parallel import launch, rank_checks
from irbfn_tpu_torch.train import params_from_jax
from irbfn_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

WORLD = 8
EXPERTS = (2, 4, 8)
MESHES = ((4, 2), (2, 4), (1, 8))
TOL_F32 = dict(rtol=2e-6, atol=2e-6)
TOL_F64 = dict(rtol=1e-10, atol=1e-10)
TOL_STEP = 1e-5
EPOCH_CASES = ("shared", "cluster")  # the cluster net's labels are extra
EPOCH_BATCH, EPOCHS = 16, 2  # 2 steps an epoch
GEOMETRY = dict(
    in_features=8, out_features=10, num_kernels=16, basis_func="gaussian",
    num_regions=8, lower_bounds=[[-2.0, 0.0], [1.0, 4.0], [-1.0, 0.0]],
    upper_bounds=[[0.0, 2.0], [4.0, 7.0], [0.0, 1.0]],
    dimension_ranges=[[i, j, k] for i in range(2) for j in range(2)
                      for k in range(2)],
    activation_idx=[0, 2, 6], delta=[15.0, 100.0, 10.0])
CONFIGS = {
    "shared": dict(GEOMETRY, model_class="WCRBFNet"),
    "per_region": dict(GEOMETRY, model_class="WCRBFNet",
                       head_mode="per_region",
                       input_scale=[1.0, 2.0, 0.5, 1.0, 1.0, 0.5, 1.5, 4.0]),
    "deeper": dict(GEOMETRY, model_class="DeeperWCRBFNet"),
    "cluster": dict(in_features=8, out_features=10, num_kernels=16,
                    basis_func="gaussian", num_regions=8,
                    model_class="ClusterWCRBFNet"),
}
LOSSES = {"cluster": "cluster_fullint_loss"}


def _batch():
    """The batch of tests/test_expert_parallel.py, and cluster labels."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32).astype(np.float64)
    y = rng.normal(size=(32, 10)).astype(np.float32).astype(np.float64)
    return x, y, rng.integers(0, 8, 32)


def _variables(name, x):
    """JAX-initialised f64 weights, nudged so that no bias is zero."""
    jmodel = jmodels.from_config(CONFIGS[name])
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.default_rng(3)
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * rng.standard_normal(np.shape(a)), variables)
    return jmodel, variables


def _case(name, dtype):
    x, y, ids = _batch()
    _, variables = _variables(name, x)
    state = {k: v.numpy() for k, v in
             params_from_jax(variables, CONFIGS[name]).items()}
    return dict(config=CONFIGS[name], state=state, x=x, y=y,
                extra=ids if name == "cluster" else None, dtype=dtype,
                loss=LOSSES.get(name, "frenet_fullint_loss"))


def _port(case):
    dtype = getattr(torch, case["dtype"])
    model = tmodels.from_config(case["config"], dtype=dtype, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v, dtype=dtype)
                           for k, v in case["state"].items()})
    return model


def _gate_sum(case, x):
    """Each row's sum of the raw region gates."""
    m = _port(case)
    act = list(m.activation_idx)
    g = tbox_gate(torch.as_tensor(x)[:, act], m.gate_lb[:, act],
                  m.gate_ub[:, act], m.gate_delta[act])
    return g.sum(-1).numpy()


def _out(t):
    return (t[0] if isinstance(t, tuple) else t).detach().numpy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job on eight gloo ranks: ({job: [result of rank r]}, cases)."""
    cases = {(n, d): _case(n, d) for n in CONFIGS
             for d in ("float32", "float64")}
    jobs = [("forward", cases[n, d], e) for (n, d) in cases for e in EXPERTS]
    jobs += [("step", cases[n, "float64"], d, e) for n in CONFIGS
             for d, e in MESHES]
    jobs += [("epochs", cases[n, "float64"], d, e, EPOCH_BATCH, EPOCHS)
             for n in EPOCH_CASES for d, e in MESHES]
    per_rank = launch.spawn(rank_checks.run_jobs, WORLD, "cpu", jobs,
                            store_dir=tmp_path_factory.mktemp("ranks"))
    keys = [(j[0], j[1]["config"]["model_class"], j[1]["config"].get(
        "head_mode"), j[1]["dtype"]) + tuple(j[2:]) for j in jobs]
    return {k: [r[i] for r in per_rank] for i, k in enumerate(keys)}, cases


def _key(kind, name, dtype, *rest):
    c = CONFIGS[name]
    return (kind, c["model_class"], c.get("head_mode"), dtype) + rest


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("expert", EXPERTS)
def test_torch_ep_forward_matches_replicated_f32(ranks, name, expert):
    results, cases = ranks
    case = cases[name, "float32"]
    model = _port(case)
    x = torch.as_tensor(case["x"], dtype=torch.float32)
    with torch.no_grad():
        ref_fused = _out(model(x))
    ref_module = _out(model(x))
    R = CONFIGS[name]["num_regions"]
    for rank, res in enumerate(results[_key("forward", name, "float32",
                                            expert)]):
        r0 = (rank % expert) * (R // expert)
        assert res["range"] == (r0, r0 + R // expert)
        assert res["centers"][0] == R // expert
        np.testing.assert_allclose(res["fused"], ref_fused, **TOL_F32,
                                   err_msg=f"rank {rank} fused")
        np.testing.assert_allclose(res["module"], ref_module, **TOL_F32,
                                   err_msg=f"rank {rank} module")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_torch_ep_forward_matches_jax_sharded_f64(ranks, name):
    results, cases = ranks
    x = _batch()[0]
    jmodel, variables = _variables(name, x)
    for expert in EXPERTS:
        mesh = jmake_mesh(jax.devices()[:WORLD], expert=expert)
        with mesh:
            out = jax.jit(jmodel.apply)(jshard_params(variables, mesh),
                                        jax.device_put(jnp.asarray(x),
                                                       jdata_sharding(mesh)))
        refs = {"module": np.asarray(out[0] if isinstance(out, tuple)
                                     else out)}
        refs["fused"] = refs["module"]
        if CONFIGS[name].get("head_mode") == "per_region":  # docstring
            with torch.no_grad():
                refs["fused"] = _out(_port(cases[name, "float64"])(
                    torch.as_tensor(x)))
        for rank, res in enumerate(results[_key("forward", name, "float64",
                                                expert)]):
            for path, ref in refs.items():
                inside = np.ones(len(x), bool)
                if CONFIGS[name].get("head_mode") == "per_region":
                    inside = _gate_sum(cases[name, "float64"], x) >= 1e-6
                    np.testing.assert_allclose(
                        res[path][~inside], ref[~inside], rtol=1e-8,
                        atol=1e-8, err_msg=f"expert {expert} rank {rank} "
                        f"{path}, rows outside the regions")
                np.testing.assert_allclose(
                    res[path][inside], ref[inside], **TOL_F64,
                    err_msg=f"expert {expert} rank {rank} {path}")


def _replicated_step(case):
    """The port's step on the whole model and batch: loss, clipped grads,
    norm."""
    model = _port(case)
    trainer = ttrainer.create_trainer(model, lr=1e-3)
    norms = []
    apply = trainer.apply_gradients
    trainer.apply_gradients = lambda m=None: norms.append(apply(m))
    dyn = fullscale_params(dtype=torch.float64, device="cpu").to_vector()
    step = ttrainer.make_train_step(getattr(ttrainer, case["loss"]), dyn)
    args = [torch.as_tensor(case[k]) for k in ("x", "y", "extra")
            if case[k] is not None]
    m = step(trainer, *args)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return float(m.loss), grads, float(norms[0])


def _assembled(rank_results, expert):
    """The step's gradients as one model's: the replicated ones (equal on
    every rank), the sharded ones stacked over the expert ranks."""
    first = rank_results[0]["grads"]
    for res in rank_results:
        for n, g in res["grads"].items():
            if n not in ("centers", "log_sigs"):
                np.testing.assert_array_equal(g, first[n], err_msg=n)
    out = dict(first)
    for n in ("centers", "log_sigs"):
        if n in first:
            out[n] = np.concatenate([rank_results[e]["grads"][n]
                                     for e in range(expert)])
    return out


def _jax_sharded(name, case, data, expert):
    """JAX's sharded step: its loss, and its gradient of the loss."""
    jmodel, variables = _variables(name, case["x"])
    dyn = jfullscale(dtype=jnp.float64).to_vector()
    loss_fn = getattr(jtrainer, case["loss"])
    mesh = jmake_mesh(jax.devices()[:data * expert], expert=expert)
    extra = () if case["extra"] is None else (jnp.asarray(case["extra"]),)

    def lf(p, x, y, *e):
        return loss_fn(lambda q, v: jmodel.apply(q, v), p, x, y, *e, dyn)[0]

    with mesh:
        params = jshard_params({"params": variables["params"]}, mesh)
        place = jdata_sharding(mesh)
        args = [jax.device_put(jnp.asarray(case[k]), place)
                for k in ("x", "y")] + [jax.device_put(e, place)
                                        for e in extra]
        loss, grads = jax.jit(jax.value_and_grad(lf))(params, *args)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads),
                                        CONFIGS[name])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("data,expert", MESHES)
def test_torch_dp_ep_step_gradients(ranks, name, data, expert):
    results, cases = ranks
    case = cases[name, "float64"]
    res = results[_key("step", name, "float64", data, expert)]
    loss, grads, norm = _replicated_step(case)
    for r in res:
        np.testing.assert_allclose(r["loss"], loss, rtol=TOL_STEP)
        np.testing.assert_allclose(r["norm"], norm, rtol=1e-12)
    got = _assembled(res, expert)
    assert set(got) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got[n], g, rtol=TOL_STEP,
                                   atol=TOL_STEP * 1e-6 * np.abs(g).max(),
                                   err_msg=n)
    jloss, jgrads = _jax_sharded(name, case, data, expert)
    np.testing.assert_allclose(res[0]["loss"], jloss, rtol=TOL_STEP)
    scale = max(norm, 1.0)  # the clip divided by norm / max_grad_norm
    for n, g in jgrads.items():
        np.testing.assert_allclose(got[n] * scale, g.numpy(), rtol=TOL_STEP,
                                   atol=TOL_STEP * 1e-6 * float(
                                       g.abs().max()), err_msg=n)


@pytest.mark.parametrize("name", EPOCH_CASES)
@pytest.mark.parametrize("data,expert", MESHES)
def test_torch_dp_ep_train_epochs(ranks, name, data, expert):
    results, cases = ranks
    case = cases[name, "float64"]
    model = _port(case)
    trainer = ttrainer.create_trainer(model, lr=1e-3)
    dyn = fullscale_params(dtype=torch.float64, device="cpu").to_vector()
    step = ttrainer.make_train_step(getattr(ttrainer, case["loss"]), dyn)
    _, mean = ttrainer.train_epochs(
        trainer, step, torch.as_tensor(case["x"]), torch.as_tensor(case["y"]),
        EPOCH_BATCH, EPOCHS, seed=0, extra=None if case["extra"] is None
        else torch.as_tensor(case["extra"]))
    res = results[_key("epochs", name, "float64", data, expert,
                       EPOCH_BATCH, EPOCHS)]
    for r in res:
        np.testing.assert_allclose(r["mean"], mean, rtol=1e-10)
    got = {n: np.concatenate([res[e]["params"][n] for e in range(expert)])
           if n in ("centers", "log_sigs") else res[0]["params"][n]
           for n in res[0]["params"]}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(got[n], p.detach().numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=n)
