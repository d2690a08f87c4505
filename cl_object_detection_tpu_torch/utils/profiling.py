"""torch.profiler trace capture around step ranges (``--profile DIR``).

The guarded start/stop pair is the one entry point: ``train_process``
starts a trace of the second epoch, and ``cli.train`` stops a trace left
open by an exception in its ``finally``. ``stop_trace_guarded`` writes
into the trace's directory:

  * ``trace.json``: the Chrome trace (Perfetto / chrome://tracing);
  * ``kernels.txt``: ``key_averages()`` sorted by device time;
  * ``summary.json``: the window's wall time (host clock, after a
    synchronise), the device's busy time (the sum of the kernels' own
    times) and its idle share, 1 - busy / wall.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch


class _Trace:
    def __init__(self, log_dir: str):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.log_dir = log_dir
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.stop()
        events = self.prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA)
        summary = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                   "idle_share": 1.0 - busy_us / wall_us if busy_us else None}
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        with open(os.path.join(self.log_dir, "kernels.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total", row_limit=60,
                                 max_name_column_width=90))
        with open(os.path.join(self.log_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary


_TRACE: Optional[_Trace] = None


def start_trace_guarded(log_dir: str) -> None:
    """Start a torch.profiler trace, tracking it so an exception anywhere
    up-stack can close it (``stop_trace_guarded`` in a finally)."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError(f"a trace into {_TRACE.log_dir} is already open")
    _TRACE = _Trace(log_dir)


def stop_trace_guarded() -> bool:
    """Stop the trace iff one is open and write its files; safe to call
    unconditionally."""
    global _TRACE
    if _TRACE is None:
        return False
    trace, _TRACE = _TRACE, None
    trace.stop()
    return True
