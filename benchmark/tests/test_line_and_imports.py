"""The result line's keys, and that nothing the benchmark runs holds JAX
or the JAX package, compared by whole top-level module name."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, SMALL

BASE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    line, _ = harness.run_cell("frenet_wide_pr1.sweep", 2**31 + 3, 0.3,
                               trace, SMALL["closed_loop"], device="cpu")
    keys = list(line)
    # the contract's keys, the breakdown when traced, and the numbers
    # compared under a key of their own that comes last
    want = BASE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert keys == want
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "irbfn_tpu_torch_probe", object())
    assert "irbfn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "irbfn_tpu.probe", object())
    assert "irbfn_tpu" in harness.forbidden_modules()


def _imports(path):
    """Every module a file imports, by its top-level name."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    banned = set(harness.FORBIDDEN) | {"irbfn_tpu_torch"}
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert not _imports(path) & banned, path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.goal_qp, benchmark.reference.track,"
            " benchmark.reference.vehicle, benchmark.reference.wcrbf,"
            " benchmark.reference.precision, benchmark.reference.keys\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'irbfn_tpu',"
            " 'irbfn_tpu_torch'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark import harness\n"
            "from benchmark.tests.conftest import SMALL\n"
            "harness.run_cell('goal_mpc_pr.lattice', 11, 0.2, True,"
            " SMALL['goal_lattice'], device='cpu')\n"
            "harness.run_cell('frenet_wide_pr1.sweep', 11, 0.2, False,"
            " SMALL['closed_loop'], device='cpu')\n"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    assert out[-1] == "[]"


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "goal_mpc_pr.lattice", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
