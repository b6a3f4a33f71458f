#!/usr/bin/env python3
"""Try the tuning knobs of the ADMM kernel's family variant on one card.

``irbfn_tpu_torch/ops/csrc/admm_solve.cu`` takes its goal rows per thread,
threads per block and resident blocks per SM from macros. This script
builds one library for each setting below (all nvcc processes at once),
prints registers and spills from ``ptxas -v``, solves one chunk of the
reference lattice (262,144 goals of the v_car = 8 family, 600 sweeps) with
each, and prints the time under CUDA events and the largest difference
from the plain PyTorch version. The lane variant runs on the same chunk
for comparison.

Usage, from the repository root on a machine with a GPU:
``python3 scripts/tune_admm_family.py``
"""

import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the smoke run's helpers)

# (rows per thread, threads per block, resident blocks per SM)
SETTINGS = ((2, 128, 2), (2, 64, 4), (2, 256, 1), (2, 32, 8), (2, 96, 3),
            (1, 128, 3), (1, 128, 4), (3, 64, 3))
CHUNK = 262144


def main():
    import torch

    from irbfn_tpu_torch.ops import _build, admm

    device = cs.phase_device()
    lattice_goals, _ = cs._lattice_goals()
    g = torch.as_tensor(lattice_goals[:CHUNK], device=device)
    ops = cs._admm_operands(torch.tensor([8.0], device=device), g[None])
    x_ref, _, _ = admm.admm_solve_reference(*ops, iters=600)
    stream = torch.cuda.current_stream().cuda_stream

    defines = [(f"ADMM_FAMILY_ROWS={r}", f"ADMM_FAMILY_THREADS={t}",
                f"ADMM_FAMILY_BLOCKS={b}") for r, t, b in SETTINGS]
    with ThreadPoolExecutor(len(defines)) as pool:
        results = list(pool.map(
            lambda d: _build.build("admm_solve", d), defines))
    for setting, res in zip(SETTINGS, results):
        lib = ctypes.CDLL(str(res.path))
        fn = lib.admm_solve_f32
        fn.argtypes = admm.ARGTYPES
        fn.restype = ctypes.c_int
        ptxas = cs.ptxas_summary(res.log)
        x = torch.empty_like(ops[0])
        rp = torch.empty(ops[0].shape[:2], device=device)
        rd = torch.empty_like(rp)

        def run(variant):
            rc = fn(*(t.data_ptr() for t in ops), x.data_ptr(), rp.data_ptr(),
                    rd.data_ptr(), 1, CHUNK, 8, 600, 1e-6, 1.6, variant,
                    stream)
            cs.check(rc == 0, f"launch failed: CUDA error {rc}")

        for variant in ((0, 1) if setting == SETTINGS[0] else (0,)):
            run(variant)
            torch.cuda.synchronize()
            err = cs._max_err(x, x_ref)
            runs = [cs._time_ms(lambda: run(variant), iters=3, warmup=1)
                    for _ in range(2)]
            print(f"rows/thread, threads, blocks/SM {setting} "
                  f"{admm.VARIANTS[variant]}: {min(runs):.3f} ms for "
                  f"{CHUNK:,} goals x 600 sweeps (runs {runs}); vs plain "
                  f"controls {err:.2e}; {ptxas}",
                  flush=True)


if __name__ == "__main__":
    main()
