"""Device memory of a real train step per (depth, batch, remat, frame)
(the JAX package's ``tools/mem_report.py``, which reads XLA's AOT memory
analysis; the port runs the step instead):

    python -m cl_object_detection_tpu_torch.tools.mem_report [--depth 50 101] \\
        [--batch 8 16] [--remat] [--height 608 --width 832] [--cpu]

For each configuration: ``torch.cuda.reset_peak_memory_stats``, then one
micro-step pair of ``train.step.make_train_step`` (``every_iter=2``: the
second micro-step applies Adam, which allocates its moments) on seeded
uint8 4x4 space-to-depth frames through the fused stem kernel (the
trainer's ``--fused_stem true --transfer_dtype uint8`` batches) and the
JAX tool's synthetic ground truth, then ``max_memory_allocated`` and
``max_memory_reserved``. Beside the peak: the bytes of the parameters,
their gradients and Adam's two moments (float32). ``--cpu`` runs no step
and reports those byte counts alone, which need no card.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..utils import benchlib
from . import common

GIB = 2 ** 30


def report(depth: int, batch: int, remat: bool, height: int, width: int, device) -> dict:
    from ..config import FocalConfig, ILConfig, ScheduleConfig
    from ..il.losses import LossStatics
    from ..train.optim import make_optimizer
    from ..train.state import TrainState
    from ..train.step import StepStatics, make_train_step

    on_card = device.type == "cuda"
    model = common.build_model(depth, device, remat=remat)
    trainable = [p for p in model.parameters() if p.requires_grad]
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    grad_bytes = sum(p.numel() * p.element_size() for p in trainable)
    out = {"depth": depth, "batch": batch, "remat": remat, "frame": f"{height}x{width}",
           "param_gib": param_bytes / GIB, "grad_gib": grad_bytes / GIB,
           "adam_moments_gib": 2 * grad_bytes / GIB}
    if not on_card:
        out["measured"] = "byte counts only: --cpu runs no step"
        return out
    x = torch.from_numpy(common.frames(batch, height, width, "fused")).to(device)
    boxes, labels = (torch.from_numpy(t).to(device) for t in benchlib.synthetic_gt(batch))
    state = TrainState(model, make_optimizer(ScheduleConfig(lr=1e-5, every_iter=2), model))
    step = make_train_step(model, None, common.anchors(height, width, "cpu").numpy(),
                           ILConfig(), FocalConfig(),
                           LossStatics(num_classes=common.NUM_CLASSES),
                           StepStatics(every_iter=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = benchlib.launch_counts()
    for _ in range(2):
        state, metrics = step(state, x, boxes, labels)
    torch.cuda.synchronize()
    if not torch.isfinite(metrics["total_loss"]):
        raise RuntimeError("non-finite loss in the measured micro-step pair")
    out.update(peak_allocated_gib=torch.cuda.max_memory_allocated() / GIB,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / GIB,
               launches=benchlib.launches_since(before),
               measured="one micro-step pair and its apply")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--depth", type=int, nargs="+", default=[50])
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=832)
    common.add_device_flag(ap)
    a = ap.parse_args(argv)
    device = common.device_of(a)
    for d in a.depth:
        for b in a.batch:
            t0 = time.perf_counter()
            out = report(d, b, a.remat, a.height, a.width, device)
            out["seconds"] = time.perf_counter() - t0
            benchlib.emit(out, device)
            if device.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
