"""Device milliseconds per micro-step of the student's forward and the losses: the self
stream ms of the program's span ``cldet.train.forward`` (less the
teacher's span inside it), over the micro-steps of the traced
device-only pass (``trace.profile`` runs it first, then the host pass:
``_spans.py``)."""
from port_bench.metrics import _spans


def read(rec):
    return _spans.per_call(rec, "train", "cldet.train.forward", "self_stream_ms")
