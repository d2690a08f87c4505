"""Predict throughput over batch sizes (the JAX package's
``tools/bench_sweep.py``): the full predict (forward, ``approx`` top-k,
decode, NMS; ``utils.benchlib.make_predict_sum``) of a RetinaNet of
``--depth`` at 608x832, chained (``utils.benchlib.time_chained``):

    python -m cl_object_detection_tpu_torch.tools.bench_sweep [--stem rgb|fused] \\
        [--depth 50] [--nms_impl pallas_fp] [--mfu] [--cpu] [batch ...]

``--stem fused`` sends seeded uint8 4x4 space-to-depth frames through the
fused stem kernel, ``rgb`` uint8 RGB frames through cuDNN's stem.
``--mfu`` adds the forward's FLOPs (``torch.utils.flop_counter``, on RGB
frames of the same size: the stem kernel is opaque to the counter) per
image over the time per image and the H100's dense bf16 peak.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..utils import benchlib
from . import common


def run(batch: int, stem: str = "rgb", iters: int = 20, H: int = 608, W: int = 832,
        depth: int = 50, want_mfu: bool = False, nms_impl: str = "iterative",
        device="cuda") -> dict:
    from ..config import PredictConfig

    model = common.build_model(depth, device)
    pcfg = PredictConfig(topk_method="approx", nms_impl=nms_impl)
    predict_sum = benchlib.make_predict_sum(model, common.anchors(H, W, device), pcfg, H, W)
    images = torch.from_numpy(common.frames(batch, H, W, stem)).to(device)
    dt = benchlib.time_chained(predict_sum, images, iters=iters, reps=3)
    out = {"batch": batch, "stem": stem, "depth": depth, "nms_impl": nms_impl,
           "img_per_s": batch * iters / dt}
    if want_mfu:
        rgb = torch.from_numpy(common.frames(batch, H, W, "rgb")).to(device)
        with torch.inference_mode():
            flops = benchlib.count_flops(lambda: model(rgb, enable_act=False))
        out["forward_flops_per_image"] = flops / batch
        out["mfu"] = flops / batch * out["img_per_s"] / benchlib.BF16_FLOPS
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("batch", type=int, nargs="*", default=[8, 16, 32])
    ap.add_argument("--stem", default="rgb", choices=["rgb", "fused"])
    ap.add_argument("--depth", type=int, nargs="+", default=[50],
                    help="backbone depths (18/34/50/101/152)")
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=832)
    ap.add_argument("--nms_impl", default="iterative",
                    choices=["pallas_fp", "iterative", "scan"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mfu", action="store_true",
                    help="also report the predict's MFU against the H100's bf16 peak")
    common.add_device_flag(ap)
    a = ap.parse_args(argv)
    device = common.device_of(a)
    for depth, b in ((d, b) for d in a.depth for b in a.batch):
        before = benchlib.launch_counts()
        t0 = time.perf_counter()
        out = run(b, a.stem, a.iters, a.height, a.width, depth, a.mfu, a.nms_impl, device)
        out["launches"] = benchlib.launches_since(before)
        out["seconds"] = time.perf_counter() - t0
        benchlib.emit(out, device)


if __name__ == "__main__":
    main()
