"""The whole micro-step's share of the card's peak: the least time of its
convs at 989 TFLOP/s (``flops.train_step_macs``: the student's forward
and backward and the teacher's forward) over the window's time per
micro-step on each rank."""
from port_bench import bounds, flops


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    w = rec["work"]
    macs = flops.train_step_macs(w["config"], w["num_classes"], w["num_past"], *w["frame"])
    least = 2.0 * macs * w["batch"] / bounds.BF16_FLOPS
    return 100.0 * least / (rec["window_s"] / rec["steps"])
