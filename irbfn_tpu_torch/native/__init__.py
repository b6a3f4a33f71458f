"""Host (C++) components of the port, built on first use and bound with
ctypes.

Port of ``irbfn_tpu/native/__init__.py``, with the port's own copies of the
sources in ``csrc/``:

- ``clothoid_oracle``: an independent f64 G1-Hermite solver, the test
  oracle of ``solvers/clothoid.py`` (it shares no code or numerical kernels
  with it);
- ``TableStore``: a memory-mapped binary solution-table store (O(1) open,
  random-index gather for permutation batching, append streaming);
- ``edt``: the exact multithreaded Euclidean distance transform
  (Felzenszwalb) of an occupancy grid.

``load()`` compiles the three sources with ``g++`` into
``build/native/libirbfn_torch_native-<hash>.so`` at the repository root
(``build/`` is in ``.gitignore``); the hash covers the sources and the
flags, so an edited source rebuilds. Without ``g++`` it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("clothoid_oracle.cpp", "table_io.cpp", "edt.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the sources unless a library of them exists; its path."""
    gxx = shutil.which("g++")
    srcs = [CSRC_DIR / s for s in SOURCES]
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libirbfn_torch_native-{digest[:16]}.so"
    if out.exists():
        return out
    if gxx is None:
        raise RuntimeError("g++ not found: the port's native module "
                           f"({', '.join(SOURCES)}) is compiled on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                           *map(str, srcs)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {CSRC_DIR}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    c = ctypes.c_double
    fp = ctypes.POINTER(ctypes.c_float)
    lib.clothoid_g1_solve.restype = ctypes.c_int
    lib.clothoid_g1_solve.argtypes = [c] * 6 + [ctypes.POINTER(c)] * 3
    lib.clothoid_g1_solve_batch.restype = None
    lib.clothoid_g1_solve_batch.argtypes = [
        ctypes.POINTER(c), ctypes.c_int64, ctypes.POINTER(c),
        ctypes.POINTER(ctypes.c_int32)]
    lib.table_create.restype = ctypes.c_int
    lib.table_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                 ctypes.c_uint32]
    lib.table_append.restype = ctypes.c_int
    lib.table_append.argtypes = [ctypes.c_char_p, fp, fp, fp,
                                 ctypes.c_uint64]
    lib.table_open.restype = ctypes.c_void_p
    lib.table_open.argtypes = [ctypes.c_char_p]
    lib.table_rows.restype = ctypes.c_uint64
    lib.table_rows.argtypes = [ctypes.c_void_p]
    lib.table_in_dim.restype = ctypes.c_uint32
    lib.table_in_dim.argtypes = [ctypes.c_void_p]
    lib.table_out_dim.restype = ctypes.c_uint32
    lib.table_out_dim.argtypes = [ctypes.c_void_p]
    lib.table_gather.restype = ctypes.c_uint64
    lib.table_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64,
        fp, fp, fp]
    lib.table_read_range.restype = ctypes.c_uint64
    lib.table_read_range.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, fp, fp, fp]
    lib.table_close.restype = None
    lib.table_close.argtypes = [ctypes.c_void_p]
    lib.edt_f32.restype = None
    lib.edt_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, fp]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (False where there is no
    g++): the JAX package's ``available``."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def clothoid_g1_solve(x0: float, y0: float, th0: float, x1: float,
                      y1: float, th1: float):
    """One G1-Hermite solve from (x0, y0, th0) to (x1, y1, th1):
    ``(status, k0, dk, length)``, status 0 = converged."""
    k0, dk, length = ctypes.c_double(), ctypes.c_double(), ctypes.c_double()
    status = load().clothoid_g1_solve(x0, y0, th0, x1, y1, th1,
                                      ctypes.byref(k0), ctypes.byref(dk),
                                      ctypes.byref(length))
    return status, k0.value, dk.value, length.value


def clothoid_g1_solve_batch(goals: np.ndarray):
    """Solve (N, 3) [x, y, theta] goals from the origin with the C++
    oracle: ``(params (N, 5) [k0, k1, k2, k3, s], status (N,))``, status 0
    = converged."""
    goals = np.ascontiguousarray(goals, np.float64)
    n = goals.shape[0]
    out = np.empty((n, 5), np.float64)
    status = np.empty((n,), np.int32)
    load().clothoid_g1_solve_batch(
        goals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, status


# the JAX package's name for the batched oracle
clothoid_oracle = clothoid_g1_solve_batch


def edt(free: np.ndarray, resolution: float = 1.0) -> np.ndarray:
    """Exact EDT of a binary grid (nonzero = free): per-cell distance in
    meters to the nearest obstacle cell (0 inside obstacles); equal to
    ``resolution * scipy.ndimage.distance_transform_edt(free != 0)``."""
    free = np.ascontiguousarray(np.asarray(free) != 0, np.uint8)
    h, w = free.shape
    out = np.empty((h, w), np.float32)
    load().edt_f32(free.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                   resolution, _fp(out))
    return out


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class TableStore:
    """Memory-mapped solution-table store (see the module docstring)."""

    def __init__(self, path: str):
        self.path = path
        self._handle = None

    @staticmethod
    def create(path: str, in_dim: int, out_dim: int) -> "TableStore":
        rc = load().table_create(path.encode(), in_dim, out_dim)
        if rc != 0:
            raise OSError(f"table_create failed ({rc}) for {path}")
        return TableStore(path)

    def append(self, inputs: np.ndarray, outputs: np.ndarray,
               valid: np.ndarray):
        from irbfn_tpu_torch.parallel.datagen import controls_block

        inputs = np.ascontiguousarray(inputs, np.float32)
        # (N, T, 2) control sequences flatten to the canonical block layout
        outputs = np.ascontiguousarray(controls_block(outputs), np.float32)
        valid = np.ascontiguousarray(valid, np.float32)
        rc = load().table_append(self.path.encode(), _fp(inputs),
                                 _fp(outputs), _fp(valid), inputs.shape[0])
        if rc != 0:
            raise OSError(f"table_append failed ({rc})")

    def open(self):
        self._handle = load().table_open(self.path.encode())
        if not self._handle:
            raise OSError(f"table_open failed for {self.path}")
        return self

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()

    @property
    def n_rows(self) -> int:
        return load().table_rows(self._handle)

    @property
    def in_dim(self) -> int:
        return load().table_in_dim(self._handle)

    @property
    def out_dim(self) -> int:
        return load().table_out_dim(self._handle)

    def _read(self, n: int, call):
        inputs = np.empty((n, self.in_dim), np.float32)
        outputs = np.empty((n, self.out_dim), np.float32)
        valid = np.empty((n,), np.float32)
        got = call(_fp(inputs), _fp(outputs), _fp(valid))
        return inputs[:got], outputs[:got], valid[:got] > 0.5

    def gather(self, indices: np.ndarray):
        """Random-index batch read (permutation mini-batching)."""
        indices = np.ascontiguousarray(indices, np.int64)
        ptr = indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        return self._read(indices.shape[0], lambda *o: load().table_gather(
            self._handle, ptr, indices.shape[0], *o))

    def read_range(self, start: int, n: int):
        return self._read(n, lambda *o: load().table_read_range(
            self._handle, start, n, *o))

    def close(self):
        if self._handle:
            load().table_close(self._handle)
            self._handle = None


__all__ = ["TableStore", "available", "build", "clothoid_g1_solve",
           "clothoid_g1_solve_batch", "clothoid_oracle", "edt", "load"]
