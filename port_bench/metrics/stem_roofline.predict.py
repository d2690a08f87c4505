"""The fused bfloat16 stem kernel's share of its roofline in the traced
predict batches: the launches' least time (``bounds.stem_bound_s``) over
their device time in the profiler's trace."""
from port_bench import bounds


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "predict" or tr is None:
        return None
    seconds, launches = tr.kernel_s("stem_fused_kernel")
    if not launches or seconds <= 0:
        return None
    h, w = rec["work"]["frame"]
    return 100.0 * launches * bounds.stem_bound_s(rec["work"]["batch"], h, w) / seconds
