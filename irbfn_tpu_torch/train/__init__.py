"""Training: losses, the Adam trainer, checkpoint and config I/O, and
constraint-pattern clustering. The entry points are modules of this package
run with ``python -m``: ``train_goal_mpc``, ``eval_goal_mpc``,
``train_frenet``, ``eval_offline``, ``train_cartesian``,
``train_clothoid``, ``eval_lut_accuracy`` and ``cluster_constraints``."""

from irbfn_tpu_torch.train.checkpoints import (
    checkpoint_steps,
    flatten_tree,
    input_bounds_from_config,
    load_config,
    load_model,
    params_from_jax,
    params_to_jax,
    restore_params,
    save_checkpoint,
    save_config,
    unflatten_tree,
)
from irbfn_tpu_torch.train.clustering import (
    cluster_centers,
    cluster_ids,
    save_cluster_artifacts,
    unique_activation_patterns,
)
from irbfn_tpu_torch.train.trainer import (
    StepMetrics,
    Trainer,
    cartesian_fullint_loss,
    clip_by_global_norm_,
    clothoid_endpoint_loss,
    cluster_fullint_loss,
    create_trainer,
    frenet_fullint_loss,
    frenet_oneint_loss,
    make_train_step,
    mirror_cartesian_table,
    mirror_frenet_table,
    pred_l1_loss,
    region_spec_from_table,
    train_epochs,
)

__all__ = [
    "checkpoint_steps", "flatten_tree", "input_bounds_from_config",
    "load_config", "load_model", "params_from_jax", "params_to_jax",
    "restore_params", "save_checkpoint", "save_config", "unflatten_tree",
    "cluster_centers", "cluster_ids", "save_cluster_artifacts",
    "unique_activation_patterns", "StepMetrics", "Trainer",
    "cartesian_fullint_loss", "clip_by_global_norm_",
    "clothoid_endpoint_loss",
    "cluster_fullint_loss", "create_trainer", "frenet_fullint_loss",
    "frenet_oneint_loss", "make_train_step", "mirror_cartesian_table",
    "mirror_frenet_table", "pred_l1_loss", "region_spec_from_table",
    "train_epochs",
]
