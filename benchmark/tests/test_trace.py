"""The trace's reduction: busy time is the union of the kernels'
intervals, and annotations listed among the device rows are no work."""

from types import SimpleNamespace

import torch

from benchmark import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_is_the_union_of_kernels_without_annotations():
    events = [
        _ev("bench.family", 0, 1000, annotation=True),
        _ev("nccl:all_gather", 100, 400),
        _ev("ncclDevKernel_AllGather_RING_LL", 100, 400),
        _ev("admm_solve_kernel_family", 350, 600),  # overlaps the gather
        _ev("admm_solve_kernel_family", 950, 1000),
        _ev("aten::bmm", 600, 900, device=CPU),
        _ev("cudaLaunchKernel", 610, 620, device=CPU),
    ]
    prof = SimpleNamespace(events=lambda: events)
    s = trace.summarize(prof, window_s=1e-3, units=1)
    assert abs(s["busy_s"] - 550e-6) < 1e-12
    assert set(s["kernels"]) == {"ncclDevKernel_AllGather_RING_LL",
                                 "admm_solve_kernel_family"}
    assert s["launches"] == 1
    assert abs(trace.kernel_seconds(s, "ncclDevKernel") - 300e-6) < 1e-12
    assert trace.kernel_seconds(s, "rbf") is None
    # the idle gap 600-950 us is named by the host op running then, under
    # the span around it
    assert s["idle_gaps"][0][0] == "bench.family/aten::bmm"
