"""On the card, at each one-card cell's own size with a short window: the
program passes and the control (the reference in the next precision
down, in the program's place) fails a number, on three seeds. The same
readings at full length come from ``benchmark/calibrate.py``."""

import pytest

from benchmark import harness

ONE_CARD = [w["name"]
            for w in harness.load_manifest(held=True)["workloads"]
            if w["chips"] == 1]


@pytest.mark.parametrize("name", ONE_CARD)
def test_control_fails_at_the_cells_size(cuda, name):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        line, out = harness.run_cell(name, seed, 5.0, False, control=True)
        assert line["correct"], line["checks"]
        limits = {k: v["limit"] for k, v in line["checks"].items()}
        ctl = out.layer["control"]
        assert any(ctl[k] > limits[k] for k in limits), ctl
