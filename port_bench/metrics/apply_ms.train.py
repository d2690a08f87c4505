"""Device milliseconds per micro-step of the optimizer's apply (the accumulator's division,
clip, Adam): the stream ms of the program's span ``cldet.train.apply``,
summed over the applies, over the micro-steps of the traced
device-only pass (``trace.profile`` runs it first, then the host pass:
``_spans.py``)."""
from port_bench.metrics import _spans


def read(rec):
    return _spans.per_call(rec, "train", "cldet.train.apply")
