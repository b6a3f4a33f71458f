"""The checkpoint bridge: committed assets vs the orbax checkpoint they came
from, and the port's import hygiene.

``scripts/export_torch_ckpt.py`` turns ``configs/frenet_wide_pr1.yaml`` +
``ckpts/frenet_wide_pr1`` into ``irbfn_tpu_torch/assets/frenet_wide_pr1.*``
(numpy + JSON, readable without JAX). Re-exporting must give bit-equal
arrays and an equal config, and the port's forward on those weights must
equal flax's.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.train import load_config as jload_config
from irbfn_tpu.train import load_model as jload_model
from irbfn_tpu_torch.train import (flatten_tree, load_model, params_from_jax,
                                   unflatten_tree)

torch.set_num_threads(1)
RUN = "frenet_wide_pr1"
ASSET = os.path.join("irbfn_tpu_torch", "assets", RUN)


@pytest.fixture(scope="module")
def orbax_run():
    model, variables, config = jload_model(f"configs/{RUN}.yaml",
                                           f"ckpts/{RUN}")
    return model, jax.tree.map(np.asarray, variables), config


def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_ckpt", os.path.join("scripts", "export_torch_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_reexport_is_bit_equal(tmp_path, monkeypatch):
    mod = _export_script()
    monkeypatch.setattr(sys, "argv", ["export_torch_ckpt.py", "--run", RUN,
                                      "--out_dir", str(tmp_path)])
    mod.main()
    with np.load(tmp_path / f"{RUN}.npz") as new, \
            np.load(ASSET + ".npz") as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            assert new[k].dtype == old[k].dtype
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    with open(tmp_path / f"{RUN}.json") as f_new, open(ASSET + ".json") as f:
        assert json.load(f_new) == json.load(f)


def test_torch_assets_match_orbax(orbax_run):
    _, variables, config = orbax_run
    with open(ASSET + ".json") as f:
        assert json.load(f) == config == jload_config(f"configs/{RUN}.yaml")
    flat = flatten_tree(variables)
    with np.load(ASSET + ".npz") as z:
        assert sorted(z.files) == sorted(flat)
        for k in z.files:
            np.testing.assert_array_equal(z[k], flat[k], err_msg=k)
    # unflatten inverts flatten, and load_model reads what params_from_jax
    # makes of the orbax tree
    tree = unflatten_tree(flat)
    assert jax.tree.structure(tree) == jax.tree.structure(variables)
    model, _ = load_model(ASSET + ".json", ASSET + ".npz", device="cpu")
    for k, v in params_from_jax(variables, config).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_torch_params_from_jax_forward_equals_flax(orbax_run):
    """Same weights, same f64 function: the port's forward on the committed
    assets equals flax's on the orbax weights to rounding, and the golden
    file's f64 forward is current."""
    jmodel, variables, _ = orbax_run
    with np.load(ASSET + "_golden.npz") as z:
        x, golden = z["x"].astype(np.float64), z["forward_f64"]
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    ref = np.asarray(jmodel.apply(params64, jnp.asarray(x[:256])))
    model, _ = load_model(ASSET + ".json", ASSET + ".npz",
                          dtype=torch.float64, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x[:256])).numpy()
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-9)
    np.testing.assert_allclose(golden[:256], ref, rtol=0.0, atol=1e-12)


@pytest.mark.parametrize("run", ["arch_wcrbf_pr", "cart_c1_pr", "goal_mpc_pr",
                                 "arch_wcrbf_shared"])
def test_torch_params_from_jax_other_checkpoints(run):
    """The other committed WCRBFNet checkpoints load through
    params_from_jax: per-region heads with F in {8, 7, 5} and O in {10, 2},
    another basis, and a shared head. f64 forwards agree with flax on
    inputs inside each config's trained grid."""
    from irbfn_tpu.train import input_bounds_from_config

    from irbfn_tpu_torch.models import from_config

    jmodel, variables, config = jload_model(f"configs/{run}.yaml",
                                            f"ckpts/{run}")
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             {"params": variables["params"]})
    model = from_config(config, dtype=torch.float64, device="cpu")
    model.load_state_dict(params_from_jax(variables, config))
    b = input_bounds_from_config(config)
    b = np.where(np.isfinite(b), b, np.array([-1.0, 1.0]))
    x = np.random.default_rng(0).uniform(b[:, 0], b[:, 1],
                                         size=(64, b.shape[0]))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-8)


@pytest.mark.parametrize("run", ["wide_mlp", "wide_deeper",
                                 "frenet_wide_cluster"])
def test_torch_params_from_jax_other_model_classes(run):
    """The committed checkpoints of the other model classes (MLP,
    DeeperWCRBFNet, ClusterWCRBFNet with R=500, K=10) load through
    params_from_jax; f64 forwards (and the cluster net's logits) agree with
    flax, and params_to_jax gives flax's tree back."""
    from irbfn_tpu_torch.models import from_config
    from irbfn_tpu_torch.train import params_to_jax

    jmodel, variables, config = jload_model(f"configs/{run}.yaml",
                                            f"ckpts/{run}")
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             {"params": variables["params"]})
    model = from_config(config, dtype=torch.float64, device="cpu")
    assert type(model).__name__ == config["model_class"] != "WCRBFNet"
    model.load_state_dict(params_from_jax(variables, config))
    rng = np.random.default_rng(0)
    lo = np.array([-0.4, -0.3, 1.0, -1.0, 3.0, -2.0, -0.5, -0.3])
    hi = np.array([0.4, 0.3, 7.0, 1.0, 7.0, 2.0, 0.5, 0.3])
    x = rng.uniform(lo, hi, size=(64, 8))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    ref = jmodel.apply(variables, jnp.asarray(x))
    if config["model_class"] == "ClusterWCRBFNet":
        assert out[1].shape == (64, config["num_regions"])
        np.testing.assert_allclose(out[1].numpy(), ref[1], rtol=0.0,
                                   atol=1e-9)
        out, ref = out[0], ref[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.0, atol=1e-8)
    tree = params_to_jax(model.state_dict(), config)
    assert jax.tree.structure(tree) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_torch_params_from_jax_checks_shapes(orbax_run):
    _, variables, config = orbax_run
    with pytest.raises(ValueError, match="head_kernel"):
        params_from_jax(variables, dict(config, head_mode="shared"))


def test_torch_import_leaves_jax_out():
    """The port imports torch and never jax, flax, orbax or the JAX
    package (the card's machine has none of them)."""
    code = ("import sys, irbfn_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'orbax', 'irbfn_tpu'))\n"
            "assert not bad, bad\n"
            "assert not irbfn_tpu_torch.torch.backends.cuda.matmul"
            ".allow_tf32\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
