"""Model layer: the basis registry and the WCRBFNet model family."""

from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS, get_basis
from irbfn_tpu_torch.models.wcrbf import (
    MLP,
    ClusterWCRBFNet,
    DeeperWCRBFNet,
    WCRBFNet,
    build_region_bounds,
    overlapping_segments,
    rbf_distances,
    region_activation,
    region_features,
)

MODEL_CLASSES = {
    "WCRBFNet": WCRBFNet,
    "DeeperWCRBFNet": DeeperWCRBFNet,
    "MLP": MLP,
    "ClusterWCRBFNet": ClusterWCRBFNet,
}


def from_config(config: dict, dtype=None, device=None, centers=None,
                model_class: str = "WCRBFNet", seed=None, key=None):
    """Rebuild a model from a trainer-written config dict (the YAML schema
    of ``irbfn_tpu.train.save_config``, read here from JSON), on ``device``
    (None: the card). ``centers`` warm-starts a WCRBFNet's center bank and
    ``key`` (a ``utils/prng.py`` key; ``seed=s`` means ``PRNGKey(s)``)
    draws the initial weights flax's ``init`` gives the JAX class; without
    them every weight is zero, to be loaded."""
    import torch

    name = config.get("model_class", model_class)
    if name not in MODEL_CLASSES:
        raise KeyError(f"unknown model_class {name!r}; available: "
                       f"{sorted(MODEL_CLASSES)}")
    cls = MODEL_CLASSES[name]
    kwargs = dict(
        in_features=config["in_features"],
        out_features=config["out_features"],
        num_kernels=config["num_kernels"],
        basis_func=config["basis_func"],
        num_regions=config["num_regions"],
        dtype=torch.float32 if dtype is None else dtype,
        device=device, seed=seed, key=key,
    )
    if cls is not ClusterWCRBFNet:
        kwargs.update(
            lower_bounds=config["lower_bounds"],
            upper_bounds=config["upper_bounds"],
            dimension_ranges=config["dimension_ranges"],
            activation_idx=config["activation_idx"],
            delta=config["delta"],
        )
    scale = config.get("input_scale")
    if scale is not None and cls is not MLP:
        kwargs["input_scale"] = tuple(float(v) for v in scale)
    if cls is WCRBFNet:
        kwargs.update(
            centers=centers,
            fixed_centers=config.get("fixed_centers", False),
            fixed_width=config.get("fixed_width", False),
            head_mode=config.get("head_mode", "shared"),
        )
    return cls(**kwargs)


__all__ = ["BASIS_FUNCTIONS", "get_basis", "MODEL_CLASSES", "WCRBFNet",
           "DeeperWCRBFNet", "MLP", "ClusterWCRBFNet", "build_region_bounds",
           "overlapping_segments", "rbf_distances", "region_activation",
           "region_features", "from_config"]
