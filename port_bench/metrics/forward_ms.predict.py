"""Device milliseconds of the model's forward per batch: CUDA events at
the RetinaNet's forward boundary (module hooks the harness registers),
the mean over the window's batches."""
import numpy as np


def read(rec):
    ev = rec.get("events_ms")
    if rec.get("kind") != "predict" or not ev:
        return None
    return float(np.mean(ev["forward"]))
