"""Model config and weights, as plain JSON and numpy files.

Port of ``irbfn_tpu/train/checkpoints.py``. The JAX package stores a YAML
config next to a checkpoint directory; neither format is needed here.
A run is a pair of files:

- ``<run>.json``: the config dict the YAML holds (``save_config``), the
  basis function by its registry name;
- a params npz: the JAX variables tree flattened to
  ``"params/core/centers"``-style keys (frozen centers and widths under
  ``"constants/core/..."``). ``save_checkpoint(dir, model, step)`` writes it
  as ``<dir>/step_<n>.npz``; ``scripts/export_torch_ckpt.py`` writes the
  same layout from a committed JAX checkpoint, where JAX is installed.

``load_model`` takes the config and either one npz or a checkpoint
directory (its newest step). ``params_from_jax`` and ``params_to_jax`` map
between the JAX tree and the port's ``state_dict`` for all four model
classes, so a net made by either package loads into the other.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from irbfn_tpu_torch.models import from_config
from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def _pyify(tree):
    """numpy and torch scalars and arrays -> plain python, for JSON."""
    if isinstance(tree, dict):
        return {k: _pyify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_pyify(v) for v in tree]
    if isinstance(tree, np.generic):
        return tree.item()
    if hasattr(tree, "tolist"):
        return tree.tolist()
    return tree


def save_config(path: str, config: dict):
    """Write the model config as JSON; a basis given as a function is stored
    by its registry name."""
    config = dict(config)
    basis = config.get("basis_func")
    if callable(basis):
        names = [n for n, fn in BASIS_FUNCTIONS.items() if fn is basis]
        if not names:
            raise KeyError(f"basis function {basis!r} is not in the registry")
        config["basis_func"] = names[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_pyify(config), f, indent=1, sort_keys=True)


def load_config(path: str) -> dict:
    """A run's config: JSON, or YAML (``.yaml``/``.yml``) where PyYAML is
    importable."""
    with open(path) as f:
        if os.path.splitext(path)[1] not in (".yaml", ".yml"):
            return json.load(f)
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"{path}: a YAML config needs PyYAML; "
                              + _exported(os.path.splitext(
                                  os.path.basename(path))[0], ".json")
                              ) from e
        return yaml.safe_load(f)


def input_bounds_from_config(config: dict) -> np.ndarray:
    """Per-input-dim ``(in_features, 2)`` [lo, hi] of the trained grid (the
    union of each activation dim's segment bounds); other dims get +-inf."""
    n = int(config["in_features"])
    out = np.full((n, 2), (-np.inf, np.inf), np.float64)
    for d, lbs, ubs in zip(config.get("activation_idx", []),
                           config.get("lower_bounds", []),
                           config.get("upper_bounds", [])):
        out[int(d), 0] = float(min(lbs))
        out[int(d), 1] = float(max(ubs))
    return out


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> ``{"a/b/c": array}``."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


# state_dict name -> path in the JAX tree, per model class
_CORE = {"centers": ("core", "centers"), "log_sigs": ("core", "log_sigs")}


def _dense_paths(*layers) -> dict:
    """{"<name>_kernel": (JAX layer, "kernel"), ...}; a layer is a name
    shared by both packages or a (port name, JAX name) pair."""
    out = {}
    for layer in layers:
        ours, theirs = (layer, layer) if isinstance(layer, str) else layer
        out[f"{ours}_kernel"] = (theirs, "kernel")
        out[f"{ours}_bias"] = (theirs, "bias")
    return out


_PARAM_PATHS = {
    "WCRBFNet": {**_CORE, **_dense_paths("head")},
    "DeeperWCRBFNet": {**_CORE, **_dense_paths("pre1", "pre2", "head")},
    "ClusterWCRBFNet": {**_CORE, **_dense_paths("gate", "head")},
    "MLP": _dense_paths(*[(f"dense{i}", f"Dense_{i}") for i in range(4)]),
}


def _expected_shapes(config: dict, cls: str) -> dict:
    R, K = int(config["num_regions"]), int(config["num_kernels"])
    F, O = int(config["in_features"]), int(config["out_features"])
    core = {"centers": (R, K, F), "log_sigs": (R, K)}

    def dense(name, fan_in, fan_out):
        return {f"{name}_kernel": (fan_in, fan_out),
                f"{name}_bias": (fan_out,)}

    if cls == "WCRBFNet":
        n_feat = R * K + R if config.get("head_mode") == "per_region" else K
        return {**core, **dense("head", n_feat, O)}
    if cls == "DeeperWCRBFNet":
        H = int(config.get("hidden", 64))
        return {**core, **dense("pre1", K, H), **dense("pre2", H, H),
                **dense("head", H, O)}
    if cls == "ClusterWCRBFNet":
        return {**core, **dense("gate", F, R), **dense("head", K, O)}
    widths = (F, K // 2, K, K // 2, O)
    shapes = {}
    for i in range(4):
        shapes.update(dense(f"dense{i}", widths[i], widths[i + 1]))
    return shapes


def _model_class(config: dict) -> str:
    cls = config.get("model_class", "WCRBFNet")
    if cls not in _PARAM_PATHS:
        raise KeyError(f"unknown model_class {cls!r}")
    return cls


def params_from_jax(tree: dict, config: dict) -> dict:
    """The JAX variables tree of a model (numpy leaves) -> the port's
    ``state_dict``, for each of the four model classes. A leaf is read from
    the ``params`` collection, or from ``constants`` where the config froze
    it (``fixed_centers``, ``fixed_width``)."""
    cls = _model_class(config)
    params = tree.get("params", tree)
    consts = tree.get("constants", {})
    expect = _expected_shapes(config, cls)
    state = {}
    for name, (layer, leaf) in _PARAM_PATHS[cls].items():
        found = {**consts.get(layer, {}), **params.get(layer, {})}
        if leaf not in found:
            raise KeyError(f"{cls} checkpoint has no {layer}/{leaf}")
        if tuple(np.shape(found[leaf])) != expect[name]:
            raise ValueError(f"{name}: checkpoint shape "
                             f"{np.shape(found[leaf])} != config's "
                             f"{expect[name]}")
        state[name] = torch.from_numpy(np.array(found[leaf]))
    return state


def params_to_jax(state: dict, config: dict) -> dict:
    """``params_from_jax`` undone: the port's ``state_dict`` (tensors or
    numpy arrays) -> the JAX variables tree with numpy leaves,
    ``{"params": {...}}`` plus ``{"constants": {"core": {...}}}`` for the
    centers and log-widths the config froze."""
    cls = _model_class(config)
    frozen = set()
    if cls == "WCRBFNet":
        if config.get("fixed_centers", False):
            frozen.add("centers")
        if config.get("fixed_width", False):
            frozen.add("log_sigs")
    tree: dict = {"params": {}}
    for name, (layer, leaf) in _PARAM_PATHS[cls].items():
        v = state[name]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        coll = "constants" if name in frozen else "params"
        tree.setdefault(coll, {}).setdefault(layer, {})[leaf] = v
    return tree


def model_config_flags(model) -> dict:
    """The config keys ``params_to_jax`` reads, taken from a model itself:
    its class, and which of its center tensors are frozen."""
    flags = {"model_class": type(model).__name__}
    if flags["model_class"] == "WCRBFNet":
        flags["fixed_centers"] = not model.centers.requires_grad
        flags["fixed_width"] = not model.log_sigs.requires_grad
    return flags


_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


def _exported(run: str, ext: str) -> str:
    """Where a JAX run's config or weights are for the port: the committed
    export ``irbfn_tpu_torch/assets/<run><ext>`` if there is one, else the
    exporter's command."""
    if os.path.exists(os.path.join(ASSETS, run + ext)):
        return ("its export is "
                + os.path.join("irbfn_tpu_torch", "assets", run + ext))
    return ("export it with: JAX_PLATFORMS=cpu python "
            f"scripts/export_torch_ckpt.py --run {run}")


def checkpoint_steps(ckpt_dir: str) -> list:
    """The steps saved in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, model, step: int, keep: int = 100) -> str:
    """Write the model's weights to ``<ckpt_dir>/step_<step>.npz`` in the
    flattened JAX-key layout ``load_model`` reads, replacing a file of the
    same step (a re-run under one run name must not leave the old weights
    beside a new config), and keep the newest ``keep`` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = params_to_jax(model.state_dict(), model_config_flags(model))
    path = os.path.join(ckpt_dir, f"step_{int(step)}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten_tree(tree))
    os.replace(tmp, path)
    for old in checkpoint_steps(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"step_{old}.npz"))
    return path


def restore_params(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The JAX variables tree (numpy leaves) of a saved step, the newest
    one if ``step`` is None."""
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            run = os.path.basename(os.path.normpath(ckpt_dir))
            raise FileNotFoundError(
                f"no step_<n>.npz in {ckpt_dir} (an orbax checkpoint of the "
                "JAX package is not readable here); "
                + _exported(run, ".npz"))
        step = steps[-1]
    with np.load(os.path.join(ckpt_dir, f"step_{int(step)}.npz")) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def load_model(config_json: str, params_npz: str, device=None,
               dtype=torch.float32, step: Optional[int] = None):
    """Rebuild ``(model, config)`` from a config JSON and its weights, on
    ``device`` (None: the card). ``params_npz`` is one npz
    (``scripts/export_torch_ckpt.py`` writes such files) or a checkpoint
    directory of ``save_checkpoint`` (``step``, or its newest)."""
    config = load_config(config_json)
    if os.path.isdir(params_npz):
        tree = restore_params(params_npz, step)
    else:
        with np.load(params_npz) as z:
            tree = unflatten_tree({k: z[k] for k in z.files})
    model = from_config(config, dtype=dtype, device=device)
    model.load_state_dict(params_from_jax(tree, config))
    return model, config
