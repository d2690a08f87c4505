"""The share of rank 0's traced window in which NCCL's kernels ran on its
card (the data axis's gradient all-reduce once per apply, the metrics'
and the loss counts' all-reduces each micro-step)."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or tr is None or tr.window_s <= 0:
        return None
    seconds, launches = tr.kernel_s("nccl")
    if not launches:
        return None
    return 100.0 * seconds / tr.window_s
