"""Where a predict's time goes (the JAX package's ``tools/bench_split.py``),
by mode, at the headline serving point by default (R50, 608x832, B=32,
``approx`` top-k):

    python -m cl_object_detection_tpu_torch.tools.bench_split [--batch 32] \\
        [--height 608 --width 832] [--topk exact|approx] [--nms_impl pallas_fp] \\
        [--quantize] [--iters 20] [--cpu] [mode ...]

modes: ``fwd`` (the forward), ``det`` (the post-process alone on seeded
logits), ``full`` (forward + post-process, ``utils.benchlib.
make_predict_sum``), ``bb`` (the backbone), ``feats`` (backbone + FPN);
heads = fwd - feats, FPN = feats - bb. ``--quantize`` runs ``fwd`` and
``full`` through the int8 convs (``bb`` and ``feats`` stay float). The
frames are seeded uint8 4x4
space-to-depth frames through the fused stem kernel, as the server's.
Each mode is a chained run (``utils.benchlib.time_chained``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils import benchlib
from . import common

MODES = ("fwd", "det", "full", "bb", "feats")


def _scaled(*parts) -> torch.Tensor:
    """A scalar that depends on every output (first channel of each map)."""
    return sum(t[:, 0].float().sum() for t in parts) * 1e-6


def run(mode: str, model, device, pcfg, batch: int = 32, iters: int = 20, H: int = 608,
        W: int = 832) -> dict:
    from ..ops.nms import detect_batch
    from ..ops.quant import quantized_apply

    apply_fn = quantized_apply(model) if pcfg.quantize else model
    anchors = common.anchors(H, W, device)

    @torch.inference_mode()
    def fwd(x):
        logits, reg = apply_fn(x, enable_act=False)
        return logits[..., 0].float().sum() * 1e-6 + reg.float().sum() * 1e-9

    @torch.inference_mode()
    def feats(x):
        return _scaled(*model.forward_features(x))

    @torch.inference_mode()
    def bb(x):
        return _scaled(*model.backbone(x))

    @torch.inference_mode()
    def det(logits):
        out = detect_batch(
            logits, regs, anchors, height=H, width=W, score_thresh=pcfg.score_thresh,
            iou_thresh=pcfg.nms_iou, pre_nms_topk=pcfg.pre_nms_topk,
            max_detections=pcfg.max_detections, nms_impl=pcfg.nms_impl,
            scores_are_logits=True, topk_method=pcfg.topk_method)
        return out.scores.float().sum()

    if mode == "det":
        rng = np.random.RandomState(0)
        a = anchors.shape[0]
        x0 = torch.from_numpy(rng.randn(batch, a, common.NUM_CLASSES).astype(np.float32) - 4)
        regs = torch.from_numpy(rng.randn(batch, a, 4).astype(np.float32) * 0.1).to(device)
        x0, step = x0.to(device), det
    else:
        x0 = torch.from_numpy(common.frames(batch, H, W, "fused")).to(device)
        step = {"fwd": fwd, "feats": feats, "bb": bb,
                "full": benchlib.make_predict_sum(model, anchors, pcfg, H, W)}[mode]
    dt = benchlib.time_chained(step, x0, iters=iters, reps=3)
    return {"mode": mode, "batch": batch, "frame": f"{H}x{W}", "topk": pcfg.topk_method,
            "nms_impl": pcfg.nms_impl, "quantize": pcfg.quantize,
            "ms_per_batch": dt / iters * 1e3, "img_per_s": batch * iters / dt}


def main(argv=None) -> None:
    from ..config import PredictConfig

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("modes", nargs="*", default=["fwd", "det", "full"], choices=MODES)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--topk", default="approx", choices=["exact", "approx"])
    p.add_argument("--nms_impl", default=PredictConfig.nms_impl,
                   choices=["pallas_fp", "iterative", "scan"])
    p.add_argument("--quantize", action="store_true", help="int8 convs (ops/quant.py)")
    p.add_argument("--iters", type=int, default=20)
    common.add_device_flag(p)
    a = p.parse_args(argv)
    device = common.device_of(a)
    pcfg = PredictConfig(topk_method=a.topk, nms_impl=a.nms_impl, quantize=a.quantize)
    model = common.build_model(a.depth, device)
    for mode in a.modes:
        before = benchlib.launch_counts()
        t0 = time.perf_counter()
        out = run(mode, model, device, pcfg, a.batch, a.iters, a.height, a.width)
        out["launches"] = benchlib.launches_since(before)
        out["seconds"] = time.perf_counter() - t0
        benchlib.emit(out, device)


if __name__ == "__main__":
    main()
