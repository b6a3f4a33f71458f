"""Box-QP ADMM over goal families: the CUDA kernel and its plain version.

Port of ``irbfn_tpu/ops/pallas_admm.py``, with a leading family axis: every
family f has its own constraint rows ``A[f]``, KKT inverse ``kinv[f]``,
bounds and ``rho[f]``, shared by its G goal rows ``q[f]``. F = 1 is the
table generator's shape (one large family per launch); F = lanes with G = 1
is the planner's (``solvers/goal_mpc.py:solve_goal_mpc``). ``admm_solve``
dispatches on the device of ``q``:

- a CUDA tensor launches the hand-written Hopper kernel
  ``csrc/admm_solve.cu`` (built by ``_build.py`` at first use) or raises.
  The kernel has two variants and ``admm_variant`` picks one from (F, G):
  ``"family"`` (a thread owns two goal rows, a block shares its family's
  matrices) for many rows per family, ``"lane"`` (a warp owns one goal row
  and keeps its family's matrices in registers) for everything else;
- a CPU tensor runs ``admm_solve_reference``, the plain PyTorch version of
  the same function, which the tests and ``chip_smoke.py`` hold the kernel
  against;
- any other device raises.

Each launch is the span ``ops.admm`` and counts ``ops.admm.family`` or
``ops.admm.lane`` by variant (``utils/spans.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from irbfn_tpu_torch.utils import spans

HORIZONS = (8,)  # the MPC horizons T the kernel is compiled for
VARIANTS = ("family", "lane")  # the kernel's ``variant`` argument, by index
# The family variant's block solves FAMILY_BLOCK_ROWS goal rows of one
# family (128 threads x 2 rows, csrc/admm_solve.cu). It is the faster variant
# (~0.040 us a row against ~0.065 on an H100) once the solve fills the card's
# resident blocks and the blocks are mostly full; under that the lane variant
# wins, because a warp per row finishes 600 sweeps in ~0.1 ms where a thread
# per two rows needs ~2.5 ms however few rows there are.
FAMILY_BLOCK_ROWS = 256
FAMILY_MIN_ROWS = 40960
FAMILY_MIN_FILL = 0.625


# csrc/admm_solve.cu:admm_solve_f32: nine arrays, F, G, T, iters, sigma,
# alpha, the variant's index, the stream
ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
            + [ctypes.c_int, ctypes.c_void_p])


def admm_variant(F: int, G: int) -> str:
    """The kernel variant that serves F families of G goal rows each:
    ``"family"`` when there are at least FAMILY_MIN_ROWS rows in all and a
    family's rows fill its blocks to FAMILY_MIN_FILL or more."""
    blocks = -(-G // FAMILY_BLOCK_ROWS)
    full = G >= FAMILY_MIN_FILL * blocks * FAMILY_BLOCK_ROWS
    return "family" if F * G >= FAMILY_MIN_ROWS and full else "lane"


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def admm_solve_reference(q, A, kinv, lo, hi, rho, iters: int = 600,
                         sigma: float = 1e-6, alpha: float = 1.6):
    """Plain PyTorch ADMM in ``q``'s dtype, batched over the family axis.

    Args:
        q: (F, G, n) linear terms; A: (F, m, n) row-normalised constraints;
        kinv: (F, n, n) inverse ADMM KKT; lo, hi: (F, m); rho: (F,).
    Returns:
        x (F, G, n), r_prim (F, G), r_dual (F, G).
    """
    F, G, n = q.shape
    lo, hi = lo[:, None, :], hi[:, None, :]
    rho_b = rho[:, None, None]
    At, kinvt = A.transpose(-1, -2), kinv.transpose(-1, -2)
    x = torch.zeros_like(q)
    z = _clip(q.new_zeros((F, G, A.shape[1])), lo, hi)
    u = torch.zeros_like(z)
    for _ in range(iters):
        rhs = sigma * x - q + (rho_b * (z - u)) @ A
        x = rhs @ kinvt
        ax = alpha * (x @ At) + (1.0 - alpha) * z
        z_new = _clip(ax + u, lo, hi)
        u = u + ax - z_new
        z = z_new
    ax = x @ At
    z_next = _clip(ax + u, lo, hi)
    r_prim = (ax - z_next).abs().amax(-1)
    r_dual = rho[:, None] * ((z_next - z) @ A).abs().amax(-1)
    return x, r_prim, r_dual


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from irbfn_tpu_torch.ops._build import build

    with spans.span("ops.library", label="admm_solve"):
        res = build("admm_solve")
        lib = ctypes.CDLL(str(res.path))
    fn = lib.admm_solve_f32
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    lib.admm_family_rows_per_block.argtypes = []
    lib.admm_family_rows_per_block.restype = ctypes.c_int
    rows = lib.admm_family_rows_per_block()
    if rows != FAMILY_BLOCK_ROWS:
        raise RuntimeError(f"csrc/admm_solve.cu solves {rows} rows per block "
                           f"of its family variant, admm_variant assumes "
                           f"{FAMILY_BLOCK_ROWS}")
    lib.build_result = res
    return lib


def build_kernel():
    """Build (or find) and load the kernel's library; returns its
    ``_build.BuildResult``."""
    return _library().build_result


def _launch(q, A, kinv, lo, hi, rho, iters, sigma, alpha):
    tensors = (q, A, kinv, lo, hi, rho)
    for t in tensors:
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError("the CUDA ADMM kernel takes f32 tensors on one "
                             f"device; got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA ADMM kernel takes contiguous tensors")
    F, G, n = q.shape
    m = A.shape[1]
    T = n // 2
    if (A.shape != (F, m, n) or kinv.shape != (F, n, n)
            or lo.shape != (F, m) or hi.shape != (F, m)
            or rho.shape != (F,)):
        raise ValueError("ADMM operand shapes do not agree: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if n != 2 * T or m != 4 * T - 1 or T not in HORIZONS:
        raise ValueError(f"the CUDA ADMM kernel is compiled for horizons "
                         f"{HORIZONS} (n = 2T, m = 4T - 1); got n={n}, m={m}")
    variant = admm_variant(F, G)
    if variant == "family" and F > 65535:
        raise ValueError("the CUDA ADMM kernel's family variant takes at "
                         f"most 65535 families per launch, got {F}")
    if q.data_ptr() % 16 or A.data_ptr() % 16 or kinv.data_ptr() % 16:
        raise ValueError("the CUDA ADMM kernel reads q, A and kinv as "
                         "float4: their data must be 16-byte aligned")
    x = torch.empty_like(q)
    r_prim = q.new_empty((F, G))
    r_dual = q.new_empty((F, G))
    if F == 0 or G == 0:
        return x, r_prim, r_dual
    lib = _library()
    with spans.span("ops.admm", label=variant), \
            torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.admm_solve_f32(
            *(t.data_ptr() for t in tensors), x.data_ptr(), r_prim.data_ptr(),
            r_dual.data_ptr(), F, G, T, int(iters), float(sigma),
            float(alpha), VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"admm_solve kernel launch failed: CUDA error "
                           f"{rc}")
    spans.count(f"ops.admm.{variant}")
    return x, r_prim, r_dual


def admm_solve(q, A, kinv, lo, hi, rho, iters: int = 600,
               sigma: float = 1e-6, alpha: float = 1.6):
    """Box-QP ADMM for (F, G) goal rows sharing each family's factorization;
    the shapes of ``admm_solve_reference``.

    CUDA tensors launch the kernel (f32, horizon 8; the variant that
    ``admm_variant`` names) or raise; CPU tensors take the plain version;
    other devices raise.
    """
    if q.device.type == "cuda":
        return _launch(q, A, kinv, lo, hi, rho, iters, sigma, alpha)
    if q.device.type == "cpu":
        return admm_solve_reference(q, A, kinv, lo, hi, rho, iters, sigma,
                                    alpha)
    raise ValueError(f"admm_solve runs on CUDA or CPU tensors, not "
                     f"{q.device.type}")
