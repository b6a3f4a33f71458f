"""A run leaves no process behind: the 4-card cell's ranks start
multiprocessing's resource tracker, which some Pythons let end only after
the run's process has ended. The run is driven on four CPU processes
(gloo) under a parent that adopts whatever outlives it."""

import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

RUN = """
import sys
sys.path.insert(0, {root!r})
import multiprocessing.resource_tracker as rt
# as on a Python that does not stop the tracker when it shuts down
rt.ResourceTracker.__del__ = lambda self: None
if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    from benchmark import harness
    from benchmark.tests.conftest import SMALL
    line, _ = harness.run_cell("goal_mpc_pr.lattice_4chip", 2**31 + 5, 0.2,
                               False, SMALL["goal_lattice"], device="cpu")
    assert line["correct"], line["checks"]
    if {stop!r}:
        harness.stop_children()
"""

WATCH = """
import os, subprocess, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
harness.adopt_orphans()
subprocess.run([sys.executable, {script!r}], check=True)
left, deadline = [], time.monotonic() + 5
while time.monotonic() < deadline:
    try:
        pid, _ = os.waitpid(-1, os.WNOHANG)
    except ChildProcessError:
        break
    if pid:
        left.append(pid)
    time.sleep(0.01)
print(len(left))
"""


@pytest.mark.parametrize("stop", [True, False])
def test_nothing_outlives_a_four_rank_run(stop, tmp_path):
    script = tmp_path / "run.py"
    script.write_text(RUN.format(root=str(ROOT), stop=stop))
    out = subprocess.run(
        [sys.executable, "-c", WATCH.format(root=str(ROOT),
                                            script=str(script))],
        capture_output=True, text=True, timeout=600, check=True)
    assert int(out.stdout.split()[-1]) == (0 if stop else 1), out.stderr
