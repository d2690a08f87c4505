"""Device-idle milliseconds per micro-step in the backward: the card's idle
gaps of the traced host pass (the second, after the device-only pass:
``_spans.py``) that began while the program's span ``cldet.train.backward`` was
the innermost open ``cldet.`` span on the host, over the pass's
micro-steps."""
from port_bench.metrics import _spans


def read(rec):
    return _spans.idle_ms(rec, "train", "cldet.train.backward")
