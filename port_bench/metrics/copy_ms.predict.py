"""Milliseconds per batch of the serving entry outside the device's
forward and post-processing: the host time of the call less the two
event-timed device spans (the pageable copy in, the copies out, the
host's waits and launches), the mean over the window's batches."""
import numpy as np


def read(rec):
    ev = rec.get("events_ms")
    if rec.get("kind") != "predict" or not ev:
        return None
    host = np.asarray(rec["latencies_s"]) * 1e3
    return float(np.mean(host - np.asarray(ev["forward"]) - np.asarray(ev["postprocess"])))
