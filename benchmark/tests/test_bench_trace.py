"""The reduction from profiler events to the trace summary, on events
made by hand."""

import pytest

from benchmark.harness.trace import _union, summarize


class Ev:
    def __init__(self, name, start, dur, device=False):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def test_union_of_overlapping_intervals():
    assert _union([(0, 10), (5, 15), (20, 30)]) == 25
    assert _union([(0, 10), (2, 3)]) == 10
    assert _union([]) == 0


def test_summary_counts_busy_launches_syncs_and_gaps():
    events = [
        Ev("aten::add", 0, 100), Ev("cudaLaunchKernel", 10, 5), Ev("cudaLaunchKernelExC", 20, 5),
        Ev("cudaStreamSynchronize", 30, 50), Ev("aten::item", 200, 300),
        Ev("level_hist<3>", 40, 60, device=True), Ev("level_hist<3>", 400, 100, device=True),
        Ev("route_packed", 90, 20, device=True),
    ]
    s = summarize(events, window_s=1e-6)
    assert s.launches == 2 and s.syncs == 1
    assert s.busy_s == pytest.approx(170e-9)  # [40, 110] and [400, 500]
    assert s.kernel_seconds(["level_hist"]) == pytest.approx(160e-9)
    assert s.device_ops[0][0] == "level_hist<3>"
    assert [g[0] for g in s.idle_gaps] == ["aten::item"]
    assert s.idle_gaps[0][1] == pytest.approx(290e-9)
