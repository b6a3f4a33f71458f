"""Device ops: the fused RBF forward (CUDA kernel + plain version)."""

from irbfn_tpu_torch.ops.rbf import (
    RBFOperands,
    build_kernel,
    wcrbf_forward,
    wcrbf_forward_reference,
    wcrbf_params_to_kernel,
)

__all__ = ["RBFOperands", "build_kernel", "wcrbf_forward",
           "wcrbf_forward_reference", "wcrbf_params_to_kernel"]
