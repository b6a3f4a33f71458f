"""Device ops: the fused RBF forward and the goal-family ADMM solve, each a
hand-written CUDA kernel with its plain PyTorch version; and the raceline
geometry primitives (plain tensor code)."""

from irbfn_tpu_torch.ops import admm, rbf
from irbfn_tpu_torch.ops.geometry import (intersect_point, nearest_point,
                                          rotation_matrix, zero_to_2pi)
from irbfn_tpu_torch.ops.admm import admm_solve, admm_solve_reference
from irbfn_tpu_torch.ops.rbf import (
    RBFOperands,
    wcrbf_forward,
    wcrbf_forward_reference,
    wcrbf_params_to_kernel,
)

KERNELS = {"rbf_forward": rbf, "admm_solve": admm}


def build_kernel(name: str):
    """Build (or find) and load the named kernel's library (a key of
    ``KERNELS``, the name of its ``csrc/<name>.cu``); returns its
    ``_build.BuildResult``."""
    return KERNELS[name].build_kernel()


__all__ = ["KERNELS", "RBFOperands", "admm_solve", "admm_solve_reference",
           "build_kernel", "intersect_point", "nearest_point",
           "rotation_matrix", "wcrbf_forward", "wcrbf_forward_reference",
           "wcrbf_params_to_kernel", "zero_to_2pi"]
