"""Each backbone stage's forward time against the H100's roofline (the
JAX package's ``tools/bench_fwd_floor.py``, at its operating point by
default: R50, 608x832, B=32, bfloat16):

    python -m cl_object_detection_tpu_torch.tools.bench_fwd_floor [--batch 32] \\
        [--height 608 --width 832] [--depth 50] [--iters 20] [--cpu]

It times the cumulative modes ``stem``, ``s1`` .. ``s4`` of
``bench_backbone`` and takes each stage as the difference of two. The
stage's floor is the larger of its convs' FLOPs over the H100's dense
bf16 peak (989 TFLOP/s) and the bytes its convs must move (each conv's
input and output activations once, its weights once, in bfloat16) over
3.35 TB/s, both from ``utils.benchlib``; the conv shapes are read from
the port's modules by forward hooks on one forward. A stage far above its
floor spends its time outside the convs' arithmetic and traffic: the
frozen BN's, ReLU's and residual add's elementwise passes, which the
floor leaves out (``bench_backbone nobn`` measures the BN's).
"""
from __future__ import annotations

import argparse
import time
from typing import List

import torch

from ..utils import benchlib
from . import common
from .bench_backbone import make_backbone, run, through

STAGE_MODES = ("s1", "s2", "s3", "s4")


def stage_convs(bb, x: torch.Tensor) -> List[List[tuple]]:
    """Per stage, ``(flops, bytes)`` of each of its convs, from one
    forward of ``bb`` on the frames ``x``."""
    from ..models.resnet import Conv

    found: List[List[tuple]] = [[] for _ in bb.stage_names]
    hooks = []
    for s, names in enumerate(bb.stage_names):
        for name in names:
            for module in getattr(bb, name).modules():
                if not isinstance(module, Conv):
                    continue

                def hook(m, inp, out, s=s):
                    cout, cin, kh, kw = m.weight.shape
                    b, _, ho, wo = out.shape
                    size = out.element_size()
                    flops = 2.0 * b * ho * wo * kh * kw * cin * cout
                    moved = (inp[0].numel() + out.numel() + m.weight.numel()) * size
                    found[s].append((flops, moved))

                hooks.append(module.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            through(bb, x, len(bb.stage_names))
    finally:
        for h in hooks:
            h.remove()
    return found


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--iters", type=int, default=20)
    common.add_device_flag(p)
    a = p.parse_args(argv)
    device = common.device_of(a)

    t0 = time.perf_counter()
    cum = {}
    for mode in ("stem",) + STAGE_MODES:
        cum[mode] = run(mode, device, a.batch, a.iters, a.height, a.width, a.depth)
    x = torch.from_numpy(common.frames(a.batch, a.height, a.width, "fused")).to(device)
    convs = stage_convs(make_backbone(a.depth, torch.bfloat16, device), x)
    prev = "stem"
    for stage, mode in enumerate(STAGE_MODES):
        dt = (cum[mode]["ms_per_batch"] - cum[prev]["ms_per_batch"]) / 1e3
        flops = sum(f for f, _ in convs[stage])
        moved = sum(m for _, m in convs[stage])
        t_c, t_b = flops / benchlib.BF16_FLOPS, moved / benchlib.HBM_BYTES_PER_S
        bound = max(t_c, t_b)
        benchlib.emit({
            "stage": mode, "batch": a.batch, "frame": f"{a.height}x{a.width}",
            "ms": dt * 1e3, "conv_flops": flops, "conv_bytes": moved,
            "tflops": flops / dt / 1e12, "mfu": flops / dt / benchlib.BF16_FLOPS,
            "roofline_ms": bound * 1e3,
            "bound": "compute" if t_c >= t_b else "bandwidth",
            "x_of_roofline": dt / bound,
            "differences": ["ms", "tflops", "mfu", "x_of_roofline"],
        }, device)
        prev = mode
    benchlib.emit({"stage": "stem(fused)", "batch": a.batch, "ms": cum["stem"]["ms_per_batch"],
                   "launches": cum["stem"]["launches"],
                   "seconds": time.perf_counter() - t0}, device)


if __name__ == "__main__":
    main()
