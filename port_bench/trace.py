"""The traced window: ``torch.profiler`` around a few iterations of the
timed call, its Chrome trace read back into the device's activity
(kernels, copies, sets) and the host's operators, and the reductions that
the per-layer readers and ``breakdown`` take from it.

The iterations run twice. First with the device's activity alone
recorded: recording every host operator costs the host microseconds per
operator, which a host-bound step would show as idle device time, so the
busy time, the window and the kernels' times come from this pass (its
window is the host clock's, from one synchronize to the next). Then with
the host's operators too, for what the host was doing in each idle gap.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "port_bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Device activity (name, start us, duration us) and host operators,
    with the traced window's bounds, all on the trace's clock."""
    start_us: float
    end_us: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    iterations: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity inside the window."""
        spans = sorted((max(s, self.start_us), min(s + d, self.end_us))
                       for _, s, d in self.device)
        out: List[Tuple[float, float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_s(self, *names: str) -> Tuple[float, int]:
        """(seconds, launches) of the device activity whose name holds any
        of ``names``."""
        hits = [d for n, _, d in self.device if any(k in n for k in names)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for name, _, d in self.device:
            total[name] = total.get(name, 0.0) + d * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 50) -> List[List]:
        """Idle time of the device inside the window, summed by what the
        host was doing when each gap began (the innermost host operator
        around that instant), over the ``longest`` gaps; the ``n`` largest."""
        busy = self.busy_intervals()
        gaps, prev = [], self.start_us
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end_us > prev:
            gaps.append((prev, self.end_us))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        total: Dict[str, float] = {}
        for s, e in gaps:
            inner: Optional[Tuple[str, float]] = None
            for name, hs, hd in self.host:
                if hs <= s < hs + hd and name != WINDOW and (inner is None or hd < inner[1]):
                    inner = (name, hd)
            label = inner[0] if inner else "(no host operator)"
            total[label] = total.get(label, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def parse(events: List[dict], iterations: int, window_s: Optional[float] = None) -> Trace:
    """The trace of ``events``: the window is the ``WINDOW`` range when the
    host's operators were recorded, else ``window_s`` from the first device
    activity on."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if window:
        start, end = float(window[0]["ts"]), float(window[0]["ts"]) + float(window[0]["dur"])
    elif window_s is not None and device:
        start = min(float(e["ts"]) for e in device)
        end = start + window_s * 1e6
    else:
        raise RuntimeError("the traced window's range is missing from the trace")
    t = Trace(start, end, iterations=iterations)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            t.device.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            t.host.append((e["name"], float(e["ts"]), float(e["dur"])))
    return t


def _events(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def profile(step: Callable[[int], None], iterations: int,
            sync: Callable[[], None]) -> Tuple[Trace, Trace]:
    """Run ``step(i)`` for ``iterations`` under the profiler twice (module
    docstring), each stretch between two ``sync()``; return the device
    pass's trace and the host pass's."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    sync()
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iterations):
            step(i)
        sync()
        window_s = time.perf_counter() - t0
    device = parse(_events(prof), iterations, window_s)
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(iterations):
                step(iterations + i)
            sync()
    return device, parse(_events(prof), iterations)
