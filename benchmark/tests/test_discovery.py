"""A cell, a traffic mix, a configuration and a per-layer metric added as
files and entries, with no code edited, are found and run."""

import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT, SMALL


def test_new_files_are_picked_up(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "irbfn_tpu_torch").symlink_to(ROOT / "irbfn_tpu_torch")
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "goal_mpc_pr.json").read_text())
    conf["name"] = "goal_copy"
    (b / "configs" / "goal_copy.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "lattice.json").read_text())
    mix.update(SMALL["goal_lattice"])
    (b / "traffic" / "lattice_tiny.json").write_text(json.dumps(mix))
    (b / "cells" / "goal_copy.lattice_tiny.json").write_text(
        (b / "cells" / "goal_mpc_pr.lattice.json").read_text())
    (b / "metrics" / "families_seen.lattice_tiny.py").write_text(
        "def read(layer):\n"
        "    return len(layer.get('spans', {}).get('bench.family', []))\n")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "goal_copy", "source": "a copy",
                         "file": "benchmark/configs/goal_copy.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "goal_copy.lattice_tiny",
                           "config": "goal_copy", "traffic": "lattice_tiny",
                           "chips": 1, "why": "a test"})
    for x in m["end_to_end"]:
        if "goal_mpc_pr.lattice" in x.get("workloads", []):
            x["workloads"].append("goal_copy.lattice_tiny")
    m["per_layer"].append({"name": "families_seen.lattice_tiny",
                           "unit": "families", "better": "higher",
                           "source": "program_span", "layer": "parallel",
                           "moves": "solves_per_s",
                           "workloads": ["goal_copy.lattice_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark import harness\n"
            "assert harness.ROOT == __import__('pathlib').Path(%r)\n"
            "line, _ = harness.run_cell('goal_copy.lattice_tiny', 3, 0.2,"
            " True, device='cpu')\n"
            "print(json.dumps(line))" % (str(tmp_path), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["families_seen.lattice_tiny"]["value"] >= 1
    assert "admm_roofline.lattice" not in line["metrics"]
