"""Device milliseconds from the forward's end to the end of the predict's
device work (top-k, decode, NMS, final selection) per batch, the mean
over the window's batches."""
import numpy as np


def read(rec):
    ev = rec.get("events_ms")
    if rec.get("kind") != "predict" or not ev:
        return None
    return float(np.mean(ev["postprocess"]))
