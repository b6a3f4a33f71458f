"""The cell ``clothoid_pr.lut`` on the CPU at a small grid: a well-formed line
with ``correct`` true, plain and traced, and with the net's pass as the
parent program ran it (its own chunk loop, no ``lattice.*`` spans); a
planted fault in one output column turns ``correct`` false; and each new
reader returns None where what it reads is absent."""

import importlib.util

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT

CELL = "clothoid_pr.lut"
# 11 x 9 x 20 = 1,980 goals in chunks of 512: three whole chunks and a tail
SMALL = {"grid": {"x": [5.0, 30.0, 11], "y": [-8.0, 8.0, 9],
                  "theta": [-1.57, 1.57, 20]},
         "chunk": 512, "check_rows_per_pass": 64, "profile_passes": 1}
METRICS = ("rbf_roofline.lut", "outside_kernel_share.lut",
           "pipeline_idle_share.lut", "idle_share.lut", "step_mfu.lut")


def _run(trace=False, **kw):
    return harness.run_cell(CELL, 2**32 + 17, 0.2, trace, SMALL,
                            device="cpu", **kw)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _old_net_params(model, goals, chunk=1 << 18):
    """``net_params`` as the parent program had it: its own chunk loop."""
    dev = next(model.parameters()).device
    out = np.empty((goals.shape[0], model.out_features), np.float32)
    with torch.no_grad():
        for i0 in range(0, goals.shape[0], chunk):
            x = torch.as_tensor(goals[i0:i0 + chunk], dtype=torch.float32,
                                device=dev)
            out[i0:i0 + chunk] = model(x).cpu().numpy()
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_and_is_correct(trace):
    line, out = _run(trace, control=not trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] % 1980 == 0 and line["failed"] == 0
    if trace:
        # a CPU run: what needs the card's trace is left out, never zero
        assert set(line["metrics"]) <= set(METRICS)
        assert "step_mfu.lut" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"solves_per_s", "setup_s"}
        limit = line["checks"]["param_gap"]["limit"]
        assert out.layer["control"]["param_gap"] > limit


@pytest.mark.parametrize("trace", [False, True])
def test_the_parent_program_gives_a_line(monkeypatch, trace):
    from irbfn_tpu_torch.train import eval_lut_accuracy

    monkeypatch.setattr(eval_lut_accuracy, "net_params", _old_net_params)
    line, out = _run(trace)
    assert line["correct"], line["checks"]
    if trace:
        assert "pipeline_idle_share.lut" not in line["metrics"]
        assert out.layer["rbf_rows"] is None
        assert not any(m[0].startswith("lattice.")
                       for m in out.layer["program"][0]["marks"])


def test_an_altered_output_column_is_caught(monkeypatch):
    from irbfn_tpu_torch.models.wcrbf import WCRBFNet

    forward = WCRBFNet.forward

    def altered(self, x):
        y = forward(self, x)
        return torch.cat([y[:, :2], y[:, 2:3] + 0.1, y[:, 3:]], dim=-1)

    monkeypatch.setattr(WCRBFNet, "forward", altered)
    line, _ = _run()
    assert not line["correct"], line["checks"]


def _parent_layer() -> dict:
    """What the driver records of the parent's program on the card: a
    trace with its RBF kernels, no ``ops.rbf.rows`` counter, no port span
    in the pass."""
    trace = dict(busy_s=0.5, window_s=0.55, units=1,
                 kernels={"rbf_partial_kernel<8, 12>": [0.5, 25]})
    view = dict(device=[[0.0, 5e5, False]], marks=[], setup=[], window=[])
    return dict(trace=trace, chips=1, program=[view],
                dims=(128, 256, 3, 5), pass_flops=5.25e12, rbf_rows=None,
                rbf_forwards=25, rbf_kernel_s=0.5)


def test_readers_return_none_where_nothing_is_recorded():
    for name in METRICS:
        assert _reader(name)({}) is None, name
    layer = _parent_layer()
    assert _reader("rbf_roofline.lut")(layer) is None
    assert _reader("pipeline_idle_share.lut")(layer) is None
    for name in ("outside_kernel_share.lut", "idle_share.lut",
                 "step_mfu.lut"):
        assert _reader(name)(layer) is not None, name


def test_rbf_roofline_counts_what_the_program_ran():
    """The whole grid's rows in 25 launches at the net's widths: the
    counted work over the kernel's device time."""
    from benchmark import counts

    layer = dict(_parent_layer(), rbf_rows=6_384_938)
    ops = counts.rbf_forward_ops(6_384_938, 128, 256, 3, 5)
    want = 100.0 * ops / counts.PEAKS["f32_flops_per_s"] / 0.5
    assert _reader("rbf_roofline.lut")(layer) == pytest.approx(want)
