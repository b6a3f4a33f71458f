"""Checkpoint and config I/O (training itself is still to be ported)."""

from irbfn_tpu_torch.train.checkpoints import (
    flatten_tree,
    input_bounds_from_config,
    load_config,
    load_model,
    params_from_jax,
    unflatten_tree,
)

__all__ = ["flatten_tree", "input_bounds_from_config", "load_config",
           "load_model", "params_from_jax", "unflatten_tree"]
