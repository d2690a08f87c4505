"""Device milliseconds per batch of the frames' copy to the card in the serving entry: the
stream ms of the program's span ``cldet.serve.copy_in``, over the batches of the traced
device-only pass (``trace.profile`` runs it first, then the host pass:
``_spans.py``)."""
from port_bench.metrics import _spans


def read(rec):
    return _spans.per_call(rec, "predict", "cldet.serve.copy_in")
