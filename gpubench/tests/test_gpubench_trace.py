"""The reduction of a device trace (``gpubench/trace.py``) on synthetic
profiler events: kernel names shortened however their template arguments
are cut, busy time and idle gaps by the harness span open, and each
program op's calls with the device time of the kernels it launched."""
from __future__ import annotations

import pytest
import torch

from gpubench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, t0, t1, device=CPU, corr=0, linked=0,
                 shapes=(), dtypes=(), annotation=False):
        self._v = (name, t0, t1, device, corr, linked, shapes, dtypes)
        self.annotation = annotation

    def is_user_annotation(self):
        return self.annotation

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def shapes(self):
        return self._v[6]

    def dtypes(self):
        return self._v[7]


@pytest.mark.parametrize("name, short", [
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::(anonymous namespace)::silu_kernel(at::Tensor"
     "IteratorBase&)::{lambda()#1}>(at::TensorIteratorBase&)>(int, X)",
     "at::native::elementwise_kernel"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>(Params)",
     "cutlass::Kernel2"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
    ("flash_tc_kernel", "flash_tc_kernel"),
    ("cut<short", "cut"),
])
def test_kernel_names_shorten(name, short):
    assert trace._short(name) == short


def test_summarize_busy_gaps_and_ops():
    ms = 1_000_000
    events = [
        Ev(trace.WINDOW_SPAN, 0, 100 * ms),
        Ev("pump", 0, 40 * ms),
        Ev("prefill", 50 * ms, 100 * ms),
        Ev("repro_torch::mamba_scan", 50 * ms, 51 * ms, corr=7,
           shapes=[[1, 512, 8192, 16], [1, 512, 8192, 16]],
           dtypes=["float", "float"]),
        Ev("aten::mm", 52 * ms, 53 * ms, corr=8),
        Ev("scan_kernel", 55 * ms, 65 * ms, CUDA, linked=7),
        Ev("gemm<x>(int)", 70 * ms, 90 * ms, CUDA, linked=8),
        Ev("graph_kernel", 10 * ms, 30 * ms, CUDA),
        Ev("late_kernel", 95 * ms, 130 * ms, CUDA),  # cut at the window
        Ev("pump", 0, 40 * ms, CUDA, annotation=True),  # no device work
    ]
    out = trace.summarize(events)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.055)
    ops = dict(out["device_ops"])
    assert ops == pytest.approx({
        "repro_torch::mamba_scan / scan_kernel": 0.010,
        "aten::mm / gemm": 0.020, "graph_kernel": 0.020,
        "late_kernel": 0.005})
    # each gap goes to the spans open at its middle: 0-10 pump, 30-55
    # none (pump ends at 40, prefill starts at 50), 65-70 and 90-95
    # prefill
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"pump": 0.010, "none": 0.025, "prefill": 0.010})
    (shapes, dtypes, secs), = out["ops"]["repro_torch::mamba_scan"]
    assert shapes[0] == [1, 512, 8192, 16] and secs == pytest.approx(0.010)


def test_summarize_needs_the_window_span():
    with pytest.raises(RuntimeError):
        trace.summarize([Ev("pump", 0, 1)])
