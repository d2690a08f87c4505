"""The 95th percentile over every batch of the window of the host time
from handing the numpy batch to the predict entry to holding its numpy
detections (linear interpolation between order statistics)."""
import numpy as np


def read(rec):
    if rec.get("kind") != "predict" or not rec["latencies_s"]:
        return None
    return float(np.percentile(np.asarray(rec["latencies_s"]) * 1e3, 95))
