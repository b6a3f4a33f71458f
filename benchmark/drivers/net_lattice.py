"""A net over a goal grid: the configuration's committed net scores every
goal of the traffic's grid ('ij' order) as ``eval_lut_accuracy`` scores a
LUT (``net_params``, ``chunk`` rows per forward), pass after pass over the
whole grid until the window closes. Each goal's output is one solve: the
spiral (k0, k1, k2, k3, s) of the G1-Hermite boundary-value problem that
the net stands in for. The columns come back to the host and are not
written anywhere.

``correct``: once the window has closed and the program's buffers are
freed, the plain reference (``reference/wcrbf.py``, float64) scores again
rows drawn by the seed from every finished pass, and each pass's last row
(the grid's tail chunk), and compares the outputs (``judge``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, program, traffic
from benchmark.drivers import _common
from benchmark.harness import ROOT, Outcome
from benchmark.reference import precision as prec
from benchmark.reference import wcrbf
from benchmark.trace import kernel_seconds, profile, summarize

REF_BLOCK = 1024  # reference rows at a time: (1024, R, K) float64 tensors


def goal_grid(grid: dict) -> np.ndarray:
    """The grid's goals (N, 3) float32, 'ij' order: x slowest, theta
    fastest, as the LUT's generator lays them out."""
    axes = [traffic.linspace(grid[k]) for k in ("x", "y", "theta")]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(
        np.float32)


def run(cell) -> Outcome:
    from irbfn_tpu_torch.train.checkpoints import load_model
    from irbfn_tpu_torch.train.eval_lut_accuracy import net_params
    from irbfn_tpu_torch.utils import spans as port_spans

    t, c = cell.traffic, cell.config
    device = torch.device(cell.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    prec.no_tf32()
    _common.reset_peak(device)
    if cell.trace:
        program.begin()
    model, _ = load_model(str(ROOT / c["net_config"]),
                          str(ROOT / c["weights"]), device=device)
    model.eval()
    goals = goal_grid(t["grid"])
    N, chunk = goals.shape[0], int(t["chunk"])

    # set-up: one whole pass (the kernel's build, the pinned buffers, every
    # chunk's launch plan)
    out = net_params(model, goals, chunk)
    del out
    _common.sync(device)
    setup_s = time.time() - cell.t_start
    setup_records = []
    if cell.trace:
        setup_records = program.take()
        port_spans.enable(False)  # the window runs as an untraced one

    pick = traffic.rng(cell.seed, traffic.CHECK_SAMPLE)
    k_rows = min(int(t["check_rows_per_pass"]), N)
    samples, passes = [], 0
    t0 = time.perf_counter()
    while True:
        out = net_params(model, goals, chunk)
        passes += 1
        idx = np.union1d(pick.choice(N, k_rows, replace=False), [N - 1])
        samples.append((idx, np.array(out[idx])))
        del out
        if time.perf_counter() - t0 >= cell.seconds:
            break
    window = time.perf_counter() - t0

    layer, summary = {}, None
    if cell.trace:
        n_prof = int(t["profile_passes"])
        program.begin()
        before = port_spans.counters()
        with profile(device) as p:
            tp = _common.now(device)
            for _ in range(n_prof):
                with torch.profiler.record_function("bench.family"):
                    out = net_params(model, goals, chunk)
                    del out
            wall = _common.now(device) - tp
        moved = port_spans.since(before)
        window_records = program.take()
        port_spans.enable(False)
        summary = summarize(p, wall, n_prof)
        R, K, F, O = (int(c[k]) for k in ("num_regions", "num_kernels",
                                          "in_features", "out_features"))
        layer = dict(
            trace=summary, chips=1,
            program=[program.rank_view(p, setup_records, window_records)],
            dims=(R, K, F, O),
            pass_flops=counts.rbf_forward_ops(N, R, K, F, O),
            rbf_rows=moved.get("ops.rbf.rows"),
            rbf_forwards=moved.get("ops.rbf.forwards"),
            rbf_kernel_s=kernel_seconds(summary, "rbf"))
    peak = _common.memory_peak(device)
    del model
    _common.release(device)
    checks = judge(cell, goals, samples, "program", device)
    if cell.control:
        layer["control"] = judge(cell, goals, samples, "control", device)
    return Outcome(
        attempted=passes * N, failed=checks.pop("failed"),
        end_to_end={t["rate_metric"]: passes * N / window,
                    "setup_s": setup_s},
        layer=layer, checks=checks, memory_peak_bytes=peak, trace=summary,
        device_kind=_common.device_kind(device), device_count=1)


def judge(cell, goals: np.ndarray, samples: list, judged: str,
          device) -> dict:
    """The numbers that decide ``correct``, for the program's outputs
    (``judged="program"``) or for the control's (``"control"``: the
    reference in the program's place on the same goals, its head product
    in TF32 and the rest in bfloat16): ``param_gap``, the largest
    |p - p_ref| / (1 + |p_ref|) over the sampled rows and every output,
    against the reference in float64; and ``failed``, sampled rows whose
    outputs are not finite."""
    c = cell.config
    files = (str(ROOT / c["net_config"]), str(ROOT / c["weights"]))
    ref = wcrbf.load_net(*files, "f64", device)
    ctl = wcrbf.load_net(*files, "bf16", device) if judged == "control" \
        else None
    idx = np.concatenate([s[0] for s in samples])
    got = np.concatenate([s[1] for s in samples])
    x = torch.as_tensor(goals[idx], device=device)
    want = wcrbf.forward(ref, x.double(), REF_BLOCK)
    if ctl is not None:
        got = wcrbf.forward(ctl, x, REF_BLOCK).float().cpu().numpy()
    got = torch.as_tensor(got, dtype=torch.float64, device=device)
    finite = torch.isfinite(got).all(-1)
    gap = (got - want).abs() / (1.0 + want.abs())
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")),
                      gap)
    return dict(param_gap=float(gap.max()) if gap.numel() else 0.0,
                failed=int((~finite).sum()))
