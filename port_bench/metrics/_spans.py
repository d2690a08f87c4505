"""What the readers of the program's spans share: the spans
(``cl_object_detection_tpu_torch/utils/profiling.py``) that this run's
profiled passes left in the process, and the device's idle time put down
to the innermost ``cldet.`` span open on the host.

``trace.profile`` runs the cell's ``trace_steps`` (train) or
``trace_batches`` (predict) calls twice: first the device-only pass, then
the host pass. Each call is one root span (``cldet.train.step``,
``cldet.serve.batch``), so the last 2 x that many roots of that name are
this run's. Stream and host ms come from the first half, the device-only
pass, whose host is not slowed by recording operators; the idle gaps come
from the host pass's ``Trace`` (``rec["host_trace"]``), whose ``host``
list holds the spans' ``user_annotation`` ranges. On a program without
spans each reader returns None.
"""
from typing import List, Optional, Tuple

ROOT = {"train": "cldet.train.step", "predict": "cldet.serve.batch"}


def values(rec: dict, kind: str, name: str,
           field: str = "stream_ms") -> Optional[Tuple[List[float], int]]:
    """(``field`` of every ``name`` span in the device-only pass, the pass's
    calls), or None when the run recorded no such span."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or tr is None or not tr.iterations:
        return None
    try:
        from cl_object_detection_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    n = tr.iterations
    roots = [s.call for s in spans if s.parent is None and s.name == ROOT[kind]]
    if len(roots) < 2 * n:
        return None
    calls = set(roots[-2 * n:-n])
    got = [getattr(s, field) for s in spans if s.call in calls and s.name == name]
    if not got or any(v is None for v in got):
        return None
    return got, n


def per_call(rec: dict, kind: str, name: str, field: str = "stream_ms") -> Optional[float]:
    """``field`` of the ``name`` spans summed over the device-only pass, per
    call (micro-step or batch)."""
    got = values(rec, kind, name, field)
    return None if got is None else sum(got[0]) / got[1]


def idle_ms(rec: dict, kind: str, name: str) -> Optional[float]:
    """Device-idle ms per call in the host pass, of the gaps that began
    while ``name`` was the innermost open ``cldet.`` span on the host
    (every gap of the window, not only the longest)."""
    tr = rec.get("host_trace")
    if rec.get("kind") != kind or tr is None or not tr.iterations:
        return None
    spans = [(n, s, s + d) for n, s, d in tr.host if n.startswith("cldet.")]
    if not spans:
        return None
    total, prev = 0.0, tr.start_us
    for s, e in tr.busy_intervals() + [(tr.end_us, tr.end_us)]:
        if s > prev:
            inner = min((h for h in spans if h[1] <= prev < h[2]),
                        key=lambda h: h[2] - h[1], default=None)
            if inner is not None and inner[0] == name:
                total += s - prev
        prev = max(prev, e)
    return total / 1e3 / tr.iterations
