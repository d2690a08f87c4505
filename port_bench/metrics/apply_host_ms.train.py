"""Host milliseconds per apply of the optimizer (the accumulator's
division, clip, Adam's passes): the host ms of the program's span
``cldet.train.apply``, the mean over the applies of the traced
device-only pass (``trace.profile`` runs it first, then the host pass:
``_spans.py``)."""
from port_bench.metrics import _spans


def read(rec):
    got = _spans.values(rec, "train", "cldet.train.apply", "host_ms")
    return None if got is None else sum(got[0]) / len(got[0])
