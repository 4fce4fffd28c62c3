"""The benchmark's own profiler window and its reduction to numbers.

``Tracer`` wraps ``torch.profiler`` (host operators and CUDA activity)
around a block that ends in a device synchronisation, and reads the
kineto events in memory: nothing is written to disk.  The summary holds
what the per-layer readers take: the device's busy time (the union of
every kernel, copy and set on the card) against the window's host-clock
length, device time per kernel name, the host's kernel launches, CUDA-graph
replays and the calls that wait on the device, and the breakdown the result line carries
(the ten device operations that took most time, and the ten longest idle
gaps of the device, each by the host operation running at its middle).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

#: runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
#: runtime calls that replay a captured CUDA graph
GRAPH_CALLS = ("cudaGraphLaunch",)
#: runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    launches: int
    syncs: int
    graph_launches: int
    device_ops: List[list]
    idle_gaps: List[list]
    rounds: Optional[int] = None
    rows: Optional[int] = None
    extra: dict = field(default_factory=dict)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))


class Tracer:
    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._t = (0.0, 0.0)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts, record_shapes=False, with_stack=False)
        self._prof.__enter__()
        self._t = (time.perf_counter(), 0.0)
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._t = (self._t[0], time.perf_counter())
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> Summary:
        return summarize(self._prof.profiler.kineto_results.events(), self._t[1] - self._t[0])


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events, window_s: float) -> Summary:
    device, host = [], []
    kernel_ns: Dict[str, int] = {}
    launches = syncs = graphs = 0
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            s, d = e.start_ns(), e.duration_ns()
            device.append((s, s + d))
            kernel_ns[name] = kernel_ns.get(name, 0) + d
        elif name in LAUNCH_CALLS:
            launches += 1
        elif name in SYNC_CALLS:
            syncs += 1
        elif name in GRAPH_CALLS:
            graphs += 1
        elif not name.startswith(("cuda", "cu")):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    busy_ns = _union(device)
    top = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        window_s=window_s, busy_s=busy_ns * 1e-9,
        kernel_s={k: v * 1e-9 for k, v in kernel_ns.items()},
        launches=launches, syncs=syncs, graph_launches=graphs,
        device_ops=[[k, v * 1e-9] for k, v in top],
        idle_gaps=_idle_gaps(device, host),
    )


def _idle_gaps(device, host, top: int = 10) -> List[list]:
    """The ``top`` longest gaps between device activity, each named by the
    innermost host operation that spans its middle."""
    gaps, end = [], None
    for s, e in sorted(device):
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, reverse=True)[:top]
    out = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        spans = [(e - s, name) for s, e, name in host if s <= mid <= e]
        out.append([min(spans)[1] if spans else "(no host operation)", length * 1e-9])
    return out
