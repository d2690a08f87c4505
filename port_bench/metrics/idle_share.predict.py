"""The share of the traced predict window in which no kernel, copy or set
ran on the card (the profiler's timeline)."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "predict" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
