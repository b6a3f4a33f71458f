"""Model layer: the basis registry and the WCRBFNet."""

from irbfn_tpu_torch.models.kernels import BASIS_FUNCTIONS, get_basis
from irbfn_tpu_torch.models.wcrbf import (
    WCRBFNet,
    build_region_bounds,
    rbf_distances,
    region_activation,
)

_NOT_PORTED = ("DeeperWCRBFNet", "MLP", "ClusterWCRBFNet")


def from_config(config: dict, dtype=None, device=None,
                model_class: str = "WCRBFNet") -> WCRBFNet:
    """Rebuild a model from a trainer-written config dict (the YAML schema
    of ``irbfn_tpu.train.save_config``, read here from JSON)."""
    import torch

    cls = config.get("model_class", model_class)
    if cls in _NOT_PORTED:
        raise NotImplementedError(
            f"{cls} is not ported to PyTorch yet (ROADMAP.md, 'Modules to "
            "port', item 3: models)")
    if cls != "WCRBFNet":
        raise KeyError(f"unknown model_class {cls!r}")
    # fixed_centers / fixed_width only freeze parameters in training; the
    # forward is the same, and the port does not train yet
    return WCRBFNet(
        in_features=config["in_features"],
        out_features=config["out_features"],
        num_kernels=config["num_kernels"],
        basis_func=config["basis_func"],
        num_regions=config["num_regions"],
        lower_bounds=config["lower_bounds"],
        upper_bounds=config["upper_bounds"],
        dimension_ranges=config["dimension_ranges"],
        activation_idx=config["activation_idx"],
        delta=config["delta"],
        input_scale=config.get("input_scale"),
        head_mode=config.get("head_mode", "shared"),
        dtype=torch.float32 if dtype is None else dtype,
        device=device,
    )


__all__ = ["BASIS_FUNCTIONS", "get_basis", "WCRBFNet", "build_region_bounds",
           "rbf_distances", "region_activation", "from_config"]
