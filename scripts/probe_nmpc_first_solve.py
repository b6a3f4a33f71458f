#!/usr/bin/env python3
"""Is the first NMPC solve of a process bit for bit the later ones?

The probe behind fault P5 of ROADMAP.md (``irbfn_tpu_torch/solvers/
nmpc.py``, on one CUDA card). Each case runs in a fresh Python process and
solves the first 8,192 of ``chip_smoke.py`` phase 41's rows (65,536 rows of
the reference Frenet lattice, seed 41; f32, gn_iters=2, al_outer=1) three
times, and counts the rows whose controls differ between the solves.

- the ``engine*`` cases run the solver's backwards as PyTorch does by
  default, a CUDA backward on the autograd engine's worker thread (the
  port before the repair): as it is; with cuBLAS's workspace fixed
  (``CUBLAS_WORKSPACE_CONFIG``); after a matrix product; after the caching
  allocator was filled with NaN; with caching off; with blocking
  launches; after a tiny solve; and a trace of the intermediates of
  ``_fused_derivatives``, ``_newton_iteration`` and ``_line_search`` in
  a first and a second solve, naming the first that differs;
- ``calling``: the port as it is, every backward on the calling thread.

Usage: ``python3 scripts/probe_nmpc_first_solve.py`` (about 3 minutes on an
H100); one case: ``... --case NAME``; ``--device cpu --rows 64``
rehearses it on the CPU, where a backward runs on the calling thread
either way.
"""

import argparse
import ast
import contextlib
import inspect
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CASES = {  # name: (backward, environment, what runs before the solves)
    "engine": ("engine", {}, None),
    "engine_cublas_workspace": (
        "engine", {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, None),
    "engine_product_first": ("engine", {}, "product"),
    "engine_nan_allocator": ("engine", {}, "nan"),
    "engine_no_caching": (
        "engine", {"PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}, None),
    "engine_blocking": ("engine", {"CUDA_LAUNCH_BLOCKING": "1"}, None),
    "engine_tiny_solve_first": ("engine", {}, "tiny"),
    "engine_trace": ("engine", {}, "trace"),
    "calling": ("calling", {}, None),
}


def rows(n):
    from irbfn_tpu_torch.parallel import FRENET_GRID, build_lattice

    rng = np.random.default_rng(41)
    lattice = build_lattice(FRENET_GRID)
    return lattice[np.sort(rng.choice(len(lattice), 65536,
                                      replace=False))][:n]


def use_engine_threads(nmpc):
    """The solver's backwards back on the engine's worker thread."""
    import torch

    @contextlib.contextmanager
    def engine():
        with torch.enable_grad():
            yield

    nmpc._calling_thread_autograd = engine


def _fingerprint(t):
    """A sum of the tensor's bits weighted by position: equal for equal
    tensors, different for (almost surely) any other."""
    import torch

    t = t.detach().contiguous()
    v = (t.view(torch.int32).to(torch.int64) if t.dtype == torch.float32
         else t.to(torch.int64)).reshape(-1)
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return int((v * w).sum())


def trace_first_iteration(nmpc, solve):
    """Every local assigned in ``_fused_derivatives``, ``_newton_iteration``
    and ``_line_search``, recorded (by fingerprint) in two solves; the
    first record that differs, and how much of it."""
    records, keep = [], {}

    def rec(name, value):
        import torch

        if torch.is_tensor(value):
            keep[len(records)] = value.detach().cpu()
            records.append((name, _fingerprint(value)))

    nmpc._probe_record = rec
    for fname in ("_fused_derivatives", "_newton_iteration", "_line_search"):
        tree = ast.parse(textwrap.dedent(inspect.getsource(
            getattr(nmpc, fname))))

        class Record(ast.NodeTransformer):
            def visit_Assign(self, node):
                names = [n for t in node.targets for n in
                         ([t] if isinstance(t, ast.Name) else
                          getattr(t, "elts", [])) if isinstance(n, ast.Name)]
                return [node] + [ast.parse(
                    f"_probe_record({fname + ':' + n.id!r}, {n.id})").body[0]
                    for n in names]

        exec(compile(ast.fix_missing_locations(Record().visit(tree)),
                     fname, "exec"), nmpc.__dict__)
    solve()
    first, first_keep = list(records), dict(keep)
    records.clear()
    keep.clear()
    solve()
    i = next((k for k, (a, b) in enumerate(zip(first, records)) if a != b),
             None)
    if i is None:
        return "no record differs"
    a, b = first_keep.get(i), keep.get(i)
    return (f"first differing record {first[i][0]} (record {i} of "
            f"{len(first)}; the records before it equal)"
            + (f": {int((a != b).sum())} of {a.numel()} entries, by up to "
               f"{float((a.double() - b.double()).abs().max()):.3g}"
               if a is not None and b is not None else ""))


def run_case(name, out, device, n):
    import torch

    import irbfn_tpu_torch  # noqa: F401
    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.solvers import NMPCConfig, nmpc, solve_lattice_point

    backward, _, before = CASES[name]
    if backward == "engine":
        use_engine_threads(nmpc)
    device = torch.device(device)
    cfg = NMPCConfig(gn_iters=2, al_outer=1)
    p = fullscale_params(dtype=torch.float32, device=device)
    x = torch.as_tensor(rows(n), device=device)

    def solve(x=x):
        s = solve_lattice_point(x, p, cfg)
        return torch.stack([s.accel, s.steer_vel], -1).cpu().numpy()

    if before == "trace":
        print(f"{name}: {trace_first_iteration(nmpc, solve)}", flush=True)
        return
    if before == "product":
        a = torch.ones(4, 3, 3, device=device)
        (a @ a).sum().item()
    elif before == "nan":
        pool = [torch.full((1 << 20,), float("nan"), device=device)
                for _ in range(2000)]
        del pool
    elif before == "tiny":
        solve(x[:8])
    sols = [solve() for _ in range(3)]
    diff = [int((sols[0] != s).reshape(n, -1).any(-1).sum())
            for s in sols[1:]]
    np.save(out, np.stack(sols))
    print(f"{name}: rows whose controls differ, solve 1 vs 2: {diff[0]}, "
          f"1 vs 3: {diff[1]} (of {n}); max |diff| "
          f"{float(np.abs(sols[0] - sols[1]).max()):.3g}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=sorted(CASES), default=None)
    ap.add_argument("--out_dir", default=os.path.join(ROOT, "torch_runs",
                                                      "probe_first_solve"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=8192)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.case:
        return run_case(args.case, os.path.join(args.out_dir,
                                                f"{args.case}.npy"),
                        args.device, args.rows)
    for name, (_, env, _) in CASES.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--case", name,
             "--out_dir", args.out_dir, "--device", args.device,
             "--rows", str(args.rows)],
            env={**os.environ, **env})
        print(f"  ({name}: exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
    sols = {n: np.load(os.path.join(args.out_dir, f"{n}.npy"))
            for n in ("engine", "calling")}
    print("the repaired solver's first solve equals the engine-thread "
          "solver's later solves: "
          f"{np.array_equal(sols['calling'][0], sols['engine'][1])}; its "
          "first solve: "
          f"{np.array_equal(sols['calling'][0], sols['engine'][0])}",
          flush=True)


if __name__ == "__main__":
    main()
