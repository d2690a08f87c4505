"""The share of the traced training window in which no kernel, copy or
set ran on the card (rank 0's timeline on a mesh)."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
