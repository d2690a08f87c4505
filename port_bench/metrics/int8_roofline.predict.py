"""The int8 kernel's share of its roofline in the traced predict batches:
the summed least time of every quantized conv's launch at its shape
(``bounds.int8_launch_bound_s``, conv or GEMM mode as the program routes
it) over the device time of the kernel's launches (main and split-K
finish) in the profiler's trace."""
from port_bench import bounds, flops


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "predict" or tr is None or not rec["work"]["int8"]:
        return None
    seconds, launches = tr.kernel_s("int8_matmul_kernel", "int8_matmul_finish")
    if not launches or seconds <= 0:
        return None
    w = rec["work"]
    convs = flops.convs(w["config"], w["config"]["num_classes"], *w["frame"])
    per_batch, _ = bounds.int8_predict_bound_s(convs, w["batch"])
    return 100.0 * tr.iterations * per_batch / seconds
