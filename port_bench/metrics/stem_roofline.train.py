"""The fused bfloat16 stem kernel's share of its roofline in the traced
micro-steps (the student's and the teacher's forward each launch it):
the launches' least time over their device time."""
from port_bench import bounds


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or tr is None:
        return None
    seconds, launches = tr.kernel_s("stem_fused_kernel")
    if not launches or seconds <= 0:
        return None
    h, w = rec["work"]["frame"]
    return 100.0 * launches * bounds.stem_bound_s(rec["work"]["batch"], h, w) / seconds
