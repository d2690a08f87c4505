"""The port's spans and counters, and torch.profiler trace capture
(``--profile DIR``).

**Spans.** ``span(name, nbytes=0)`` is a context manager around a stretch
of the program. Its counters always count, with plain integer adds: the
calls and the bytes per name (``counters()``, ``reset_counters()``).
Everything else happens only while a ``torch.profiler`` session is active
(the flag torch's profiler sets, ``torch.autograd.profiler.
_is_profiler_enabled``). Then the span

  * opens a ``record_function`` range of its name, so the span lies in
    the profiler's trace on the same clock as the device's kernels and
    copies (a ``user_annotation`` event), and an idle gap of the device can
    be put down to the span that was open on the host;
  * records a CUDA event on the current stream at entry and at exit (once
    CUDA is initialised in the process): its *stream time* runs from the
    moment the stream reached the span's first work to the moment it
    finished its last, the device's waits inside the span included;
  * appends a record to an in-memory list: its name, its parent (the
    index of the enclosing span), the ordinal of its call, its bytes, the
    host clock at entry and exit, and its events. Spans nest on one stack
    per process: they are opened from one thread at a time (autograd's
    device thread opens those of the backward while the caller waits in
    ``backward()``, so they nest under its span). A root span's ordinal
    counts the root spans recorded before it (the micro-step, the batch);
    its descendants share it.

With no profiler active a span records no time, opens no range and makes
no event: one flag check and the counter adds. ``spans()`` reads the list
and resolves the events, after one synchronise, into per-span host ms,
stream ms and self stream ms (the stream time less the part of it that
the span's children cover). ``clear_spans()`` empties the list.

The port's spans (``cldet.``, as its operators are ``cldet::``):

  * ``cldet.train.step``: ``ILTrainer.run_batch`` (root, one per
    micro-step); its self time is the pinned batch copy in and the
    bookkeeping;
  * ``cldet.train.forward``: ``compute_losses`` in the train step, the
    student's forward and the losses;
  * ``cldet.train.teacher``: the frozen teacher's forward (in ``forward``);
  * ``cldet.train.backward``: ``total.backward()``;
  * ``cldet.train.apply``: the accumulator's division through
    ``Adam.step``: the gradient gathers and all-reduce, mask, clip, warm
    zeroing, A-GEM and the ZeRO-1 all-gather;
  * ``cldet.train.loader_wait``: ``train/loop``'s wait for the loader's
    next batch (root);
  * ``cldet.serve.batch``: a call of ``cli.serve.make_run_predict``'s
    function (root), holding ``cldet.serve.copy_in`` (bytes: the frames),
    ``cldet.predict.forward`` (``eval.predictor.make_predict_fn``'s model
    forward with the BiC or class affine), ``cldet.predict.postprocess``
    (``detect_batch``) and ``cldet.serve.copy_out`` (bytes: the four
    outputs);
  * ``cldet.mesh.<collective>``: ``parallel.mesh``'s collectives where
    they run (bytes: the buffer): ``all_reduce_sum``, ``all_reduce_sums``,
    ``all_reduce_metrics``, ``gather_model_grads``, ``param_all_gather``,
    ``model_all_reduce``, ``model_all_gather``.

**Trace capture.** The guarded start/stop pair is the one entry point:
``train_process`` starts a trace of the second epoch (on rank 0), and
``cli.train`` stops a trace left open by an exception in its ``finally``.
``start_trace_guarded`` clears the span list; ``stop_trace_guarded``
writes into the trace's directory:

  * ``trace.json``: the Chrome trace (Perfetto / chrome://tracing), the
    spans among its ``user_annotation`` ranges;
  * ``kernels.txt``: ``key_averages()`` sorted by device time;
  * ``summary.json``: the window's wall time (host clock, after a
    synchronise), the device's busy time (the sum of the kernels' own
    times) and its idle share, 1 - busy / wall;
  * ``spans.json``: per span name, the calls, bytes, host ms, stream ms
    and self stream ms of the spans recorded in the window (stream times
    null without a card).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Count(NamedTuple):
    calls: int
    bytes: int


class Span(NamedTuple):
    """One recorded span, resolved (``spans()``); the times are None while
    the span is open, the stream times without CUDA events."""
    name: str
    parent: Optional[int]
    call: int
    nbytes: int
    host_ms: Optional[float]
    stream_ms: Optional[float]
    self_stream_ms: Optional[float]


class _Record:
    __slots__ = ("name", "parent", "call", "nbytes", "t0", "t1", "events", "stream_ms",
                 "self_stream_ms")

    def __init__(self, name: str, parent: Optional[int], call: int, nbytes: int):
        self.name, self.parent, self.call, self.nbytes = name, parent, call, nbytes
        self.t0 = self.t1 = 0
        self.events = None
        self.stream_ms = self.self_stream_ms = None


_COUNTS: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
_RECORDS: List[_Record] = []
_STACK: List[int] = []
_ROOTS = 0


@contextlib.contextmanager
def span(name: str, nbytes: int = 0) -> Iterator[None]:
    """Count a call of ``name`` (and ``nbytes``); under an active profiler,
    also record it (module docstring)."""
    count = _COUNTS[name]
    count[0] += 1
    count[1] += nbytes
    if not _autograd_profiler._is_profiler_enabled:
        yield
        return
    global _ROOTS
    parent = _STACK[-1] if _STACK else None
    if parent is None:
        call, _ROOTS = _ROOTS, _ROOTS + 1
    else:
        call = _RECORDS[parent].call
    rec = _Record(name, parent, call, nbytes)
    _STACK.append(len(_RECORDS))
    _RECORDS.append(rec)
    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if rec.events is not None:
                rec.events[1].record()
            rec.t1 = time.perf_counter_ns()
            _STACK.pop()


def counters() -> Dict[str, Count]:
    """Calls and bytes per span name since the last ``reset_counters``."""
    return {k: Count(*v) for k, v in _COUNTS.items()}


def reset_counters() -> None:
    _COUNTS.clear()


def clear_spans() -> None:
    """Empty the span list (between spans, never inside one)."""
    global _ROOTS
    _RECORDS.clear()
    _ROOTS = 0


def _covered_ms(length: float, intervals: List[tuple]) -> float:
    """How much of ``[0, length]`` the union of ``intervals`` covers."""
    total, at = 0.0, 0.0
    for s, e in sorted(intervals):
        s, e = max(s, at), min(e, length)
        if e > s:
            total += e - s
            at = e
    return total


def _resolve(records: List[_Record]) -> None:
    """Stream ms and self stream ms of every closed record with events
    (once), each child placed by its events' distance from its parent's
    first."""
    closed = [r.events is not None and r.t1 != 0 for r in records]
    todo = [i for i, r in enumerate(records) if closed[i] and r.stream_ms is None]
    if not todo:
        return
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    children: Dict[int, List[_Record]] = collections.defaultdict(list)
    for i, r in enumerate(records):
        if closed[i] and r.parent is not None:
            children[r.parent].append(r)
    for i in todo:
        r = records[i]
        first, last = r.events
        r.stream_ms = first.elapsed_time(last)
        kids = [(first.elapsed_time(c.events[0]), first.elapsed_time(c.events[1]))
                for c in children[i]]
        r.self_stream_ms = r.stream_ms - _covered_ms(r.stream_ms, kids)


def spans() -> List[Span]:
    """The recorded spans in the order they opened (a span's ``parent``
    is an index into this list), resolved."""
    _resolve(_RECORDS)
    return [Span(r.name, r.parent, r.call, r.nbytes,
                 (r.t1 - r.t0) / 1e6 if r.t1 else None, r.stream_ms, r.self_stream_ms)
            for r in _RECORDS]


def _totals(recorded: List[Span]) -> Dict[str, dict]:
    """Per name: calls, bytes, and the sums of host ms, stream ms and self
    stream ms (None without events)."""
    out: Dict[str, dict] = {}
    for s in recorded:
        t = out.setdefault(s.name, {"calls": 0, "bytes": 0, "host_ms": 0.0,
                                    "stream_ms": None, "self_stream_ms": None})
        t["calls"] += 1
        t["bytes"] += s.nbytes
        t["host_ms"] += s.host_ms or 0.0
        if s.stream_ms is not None:
            t["stream_ms"] = (t["stream_ms"] or 0.0) + s.stream_ms
            t["self_stream_ms"] = (t["self_stream_ms"] or 0.0) + s.self_stream_ms
    return out


class _Trace:
    def __init__(self, log_dir: str):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.log_dir = log_dir
        clear_spans()
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
        with open(os.path.join(self.log_dir, "spans.json"), "w") as f:
            json.dump(_totals(spans()), f, indent=2)
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
