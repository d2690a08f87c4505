"""The whole predict's share of the card's peak: the least time of the
configuration's convs at the peak (``flops.predict_least_s``: the int8
convs at 1,979 TOP/s under the int8 path, the rest at 989 TFLOP/s) over
the window's time per batch."""
from port_bench import bounds, flops


def read(rec):
    if rec.get("kind") != "predict" or not rec["batches"]:
        return None
    w = rec["work"]
    least = flops.predict_least_s(w["config"], w["config"]["num_classes"], *w["frame"],
                                  w["batch"], w["int8"], bounds.BF16_FLOPS, bounds.INT8_OPS)
    return 100.0 * least / (rec["window_s"] / rec["batches"])
