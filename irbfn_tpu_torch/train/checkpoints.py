"""Model config and weights, as plain JSON and numpy files.

Port of the loading half of ``irbfn_tpu/train/checkpoints.py``. The JAX
package stores a YAML config next to an orbax checkpoint; neither YAML nor
orbax is needed here. ``scripts/export_torch_ckpt.py`` converts a committed
config + checkpoint once, where JAX is installed, into
``<run>.json`` (the same config dict) and ``<run>.npz`` (the flax
parameter tree flattened to ``"params/core/centers"``-style keys), and
``load_model`` reads those two files.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from irbfn_tpu_torch.models import from_config


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


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


def params_from_jax(tree: dict, config: dict) -> dict:
    """The flax variables tree of a WCRBFNet (numpy leaves) -> the port's
    ``state_dict``. Centers and log-widths are read from the ``params``
    collection, or from ``constants`` where the config froze them."""
    params = tree.get("params", tree)
    consts = tree.get("constants", {})
    core = {**consts.get("core", {}), **params.get("core", {})}
    R, K = int(config["num_regions"]), int(config["num_kernels"])
    F, O = int(config["in_features"]), int(config["out_features"])
    n_feat = R * K + R if config.get("head_mode") == "per_region" else K
    state = {
        "centers": core["centers"],
        "log_sigs": core["log_sigs"],
        "head_kernel": params["head"]["kernel"],
        "head_bias": params["head"]["bias"],
    }
    expect = {"centers": (R, K, F), "log_sigs": (R, K),
              "head_kernel": (n_feat, O), "head_bias": (O,)}
    for name, shape in expect.items():
        if tuple(np.shape(state[name])) != shape:
            raise ValueError(f"{name}: checkpoint shape "
                             f"{np.shape(state[name])} != config's {shape}")
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def load_model(config_json: str, params_npz: str, device=None,
               dtype=torch.float32):
    """Rebuild ``(model, config)`` from a config JSON and a params npz
    written by ``scripts/export_torch_ckpt.py``."""
    config = load_config(config_json)
    with np.load(params_npz) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    model = from_config(config, dtype=dtype, device=device)
    model.load_state_dict(params_from_jax(tree, config))
    return model, config
