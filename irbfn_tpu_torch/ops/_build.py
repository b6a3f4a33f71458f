"""Build the hand-written CUDA kernels into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/lib<name>-<hash>.so`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``. The hash covers the source
and the flags, so an edited source rebuilds and an unchanged one loads the
library already built. Nothing here runs at import: the first launch on a
CUDA tensor builds.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc's output, with ptxas' registers and spills per kernel


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (put nvcc on PATH or set CUDA_HOME)")
    return nvcc


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, proc.stdout + proc.stderr)
