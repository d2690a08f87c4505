"""Train-step throughput of the port (the JAX package's
``tools/bench_train.py``): the state-0 micro-step of
``train.step.make_train_step`` (forward, focal + smooth-L1 loss over
every anchor, backward into the accumulator, Adam every second
micro-step) on a RetinaNet of ``--depth``, in images/s.

    python -m cl_object_detection_tpu_torch.tools.bench_train [--batch 4 8] \\
        [--iters 20] [--remat] [--stem rgb|s2d|fused] [--split] [--cpu]

The ground truth is the JAX tool's: 8 boxes per image in 32 slots. The
frames are seeded uint8 pixels, normalized on the card as the trainer's
``--transfer_dtype uint8`` batches are; ``--stem fused`` sends 4x4
space-to-depth frames through the fused stem kernel (``--fused_stem`` in
training), ``s2d`` 2x2 ones through the phase-packed conv.

The micro-steps chain through the model's state; CUDA events around
``--iters`` of them, one wait at the end, best of three. ``--split``
times forward, forward + loss and forward + loss + backward as chained
scalars (``utils.benchlib.time_chained``) beside the full micro-step
(optimizer = full - backward), and an MFU: the FLOPs of forward + loss +
backward as ``torch.utils.flop_counter`` counts them, over the full
micro-step's time and the H100's dense bf16 peak. The fused stem's
kernel is opaque to the counter, so the count runs the same model on RGB
frames of the same size, whose stem is the same 7x7/2 conv.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..utils import benchlib
from . import common


def _setup(depth, batch, height, width, stem, remat, device):
    from ..config import FocalConfig, ILConfig
    from ..il.losses import LossStatics

    model = common.build_model(depth, device, remat=remat)
    x = torch.from_numpy(common.frames(batch, height, width, stem)).to(device)
    boxes, labels = (torch.from_numpy(a).to(device) for a in benchlib.synthetic_gt(batch))
    anchors = common.anchors(height, width, device)
    statics = LossStatics(num_classes=common.NUM_CLASSES)
    return model, x, boxes, labels, anchors, (ILConfig(), FocalConfig(), statics)


def run(batch: int, iters: int, remat: bool, depth: int = 50, height: int = 640,
        width: int = 1024, stem: str = "rgb", device="cuda") -> float:
    """Images/s of the micro-step."""
    from ..config import ScheduleConfig
    from ..train.optim import make_optimizer
    from ..train.state import TrainState
    from ..train.step import StepStatics, make_train_step

    model, x, boxes, labels, anchors, (il_cfg, focal_cfg, statics) = _setup(
        depth, batch, height, width, stem, remat, device)
    state = TrainState(model, make_optimizer(ScheduleConfig(lr=1e-5, every_iter=2), model))
    step = make_train_step(model, None, anchors.cpu().numpy(), il_cfg, focal_cfg, statics,
                           StepStatics(every_iter=2))

    def steps():
        nonlocal state
        for _ in range(iters):
            state, metrics = step(state, x, boxes, labels)
        return metrics["total_loss"]

    for _ in range(2):                                   # warm: one micro-step pair
        state, _ = step(state, x, boxes, labels)
    best = min(benchlib.device_ms(steps, device, iters=1, warmup=0) for _ in range(3))
    return batch * iters / (best / 1e3)


def run_split(batch: int, iters: int, remat: bool, depth: int = 50, height: int = 640,
              width: int = 1024, stem: str = "rgb", device="cuda") -> dict:
    from ..il.losses import compute_losses

    model, x, boxes, labels, anchors, (il_cfg, focal_cfg, statics) = _setup(
        depth, batch, height, width, stem, remat, device)
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_of(img):
        with torch.enable_grad():
            return compute_losses(model, img, boxes, labels, anchors, il_cfg, focal_cfg,
                                  statics)[0]

    def fwd_scalar(img):
        with torch.no_grad():
            logits, reg = model(img, enable_act=False)
        return logits[..., 0].float().sum() * 1e-6 + reg.float().sum() * 1e-9

    def grad_scalar(img):
        grads = torch.autograd.grad(loss_of(img), params)
        return sum(g.float().sum() for g in grads) * 1e-9

    def per_step(fn):
        return benchlib.time_chained(fn, x, iters=iters, reps=3) / iters

    t_fwd, t_loss, t_grad = (per_step(f) for f in (fwd_scalar, loss_of, grad_scalar))
    t_full = batch / run(batch, iters, remat, depth, height, width, stem, device)

    rgb = x if stem == "rgb" else torch.from_numpy(
        common.frames(batch, height, width, "rgb")).to(device)
    flops = benchlib.count_flops(lambda: torch.autograd.grad(loss_of(rgb), params))
    return {
        "batch": batch,
        "forward_ms": t_fwd * 1e3,
        "loss_ms": (t_loss - t_fwd) * 1e3,
        "backward_ms": (t_grad - t_loss) * 1e3,
        "optimizer_ms": (t_full - t_grad) * 1e3,
        "full_step_ms": t_full * 1e3,
        "images_per_sec": batch / t_full,
        "step_flops": flops,
        "flops_source": "torch.utils.flop_counter (forward + loss + backward)",
        "mfu_vs_h100_bf16_peak": flops / t_full / benchlib.BF16_FLOPS,
        "differences": ["loss_ms", "backward_ms", "optimizer_ms"],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, nargs="+", default=[4, 8])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--split", action="store_true",
                   help="forward / loss / backward / optimizer split and MFU")
    p.add_argument("--stem", default="rgb", choices=["rgb", "s2d", "fused"],
                   help="frame layout and stem (fused = the stem kernel on 4x4 "
                        "space-to-depth frames)")
    common.add_device_flag(p)
    args = p.parse_args(argv)
    device = common.device_of(args)
    tag = "" if args.stem == "rgb" else f"_{args.stem}_stem"
    name = f"retinanet_r{args.depth}_{args.height}x{args.width}"
    for b in args.batch:
        before = benchlib.launch_counts()
        t0 = time.perf_counter()
        if args.split:
            out = run_split(b, args.iters, args.remat, args.depth, args.height, args.width,
                            args.stem, device)
            out["metric"] = f"{name}_train_split" + ("_remat" if args.remat else "") + tag
        else:
            ips = run(b, args.iters, args.remat, args.depth, args.height, args.width,
                      args.stem, device)
            out = {"metric": f"{name}_train_images_per_sec{tag}", "batch": b,
                   "value": ips, "unit": "images/s"}
        out["launches"] = benchlib.launches_since(before)
        out["seconds"] = time.perf_counter() - t0
        benchlib.emit(out, device)


if __name__ == "__main__":
    main()
