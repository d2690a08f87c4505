"""Stage-wise forward and backward of the train step (the JAX package's
``tools/bench_bwd_breakdown.py``): the backbone, the FPN, the
classification and regression head trunks and the loss, each forward
alone and forward + backward with respect to its parameters and its
input (the cotangents the whole step propagates), each a chained run
(``utils.benchlib.time_chained``):

    python -m cl_object_detection_tpu_torch.tools.bench_bwd_breakdown [--batch 8] \\
        [--height 608 --width 832] [--depth 50] [--iters 10] [--cpu]

Per stage: the backward's share (``bwd/fwd``) and the FLOP rates
(``torch.utils.flop_counter``, which counts the convs and matmuls: none
for the loss; the backbone's counted on RGB frames of the same size,
whose stem is the conv the fused stem kernel computes).
The frames are seeded float32 ``randn * 0.1`` 4x4 space-to-depth frames
through the fused stem kernel (an input that takes a gradient). A
``full_grad`` row times the whole loss's gradient beside the stages'
sum: stages timed apart lose nothing to each other here, but the sum
also counts each stage's scalar reduction.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..utils import benchlib
from . import common


def _scalar(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out.float().sum() * 1e-6
    return sum(o.float().sum() for o in out) * 1e-6


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def grad_of(fn, params):
    """``x -> scalar``: ``fn``'s gradient with respect to ``x`` and
    ``params``, summed; ``x`` (a tensor or a sequence) is made a leaf."""
    def g(x):
        xs = [t.detach().requires_grad_(True) for t in _leaves(x)]
        with torch.enable_grad():
            out = fn(xs[0] if isinstance(x, torch.Tensor) else type(x)(xs))
            grads = torch.autograd.grad(out, xs + params, allow_unused=True)
        return sum(t.float().sum() for t in grads if t is not None) * 1e-9
    return g


def main(argv=None) -> None:
    from ..config import FocalConfig, ILConfig
    from ..il.losses import LossStatics, compute_losses
    from ..ops.focal_loss import focal_loss

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--iters", type=int, default=10)
    common.add_device_flag(p)
    a = p.parse_args(argv)
    device = common.device_of(a)
    t_start = time.perf_counter()
    before = benchlib.launch_counts()

    B, H, W = a.batch, a.height, a.width
    model = common.build_model(a.depth, device)
    anchors = common.anchors(H, W, device)
    images = torch.from_numpy(common.frames(B, H, W, "fused", uint8=False)).to(device)
    rgb = torch.from_numpy(common.frames(B, H, W, "rgb", uint8=False)).to(device)
    boxes, labels = (torch.from_numpy(t).to(device) for t in benchlib.synthetic_gt(B))

    def backbone(x):
        return model.backbone(x)

    def fpn(cs):
        return model.fpn(*cs)

    def cls_head(feats):
        return torch.cat([model.classification_head(f, True) for f in feats], dim=1)

    def reg_head(feats):
        return torch.cat([model.regression_head(f) for f in feats], dim=1)

    def loss(cls_reg):
        out = focal_loss(cls_reg[0], cls_reg[1], anchors, boxes, labels)
        return out.bg_loss.mean() + out.fg_loss.mean() + out.reg_loss.mean()

    with torch.no_grad():                       # each stage's input, made once
        csets = tuple(backbone(images))
        feats = tuple(fpn(csets))
        heads = (cls_head(feats), reg_head(feats))

    def params_of(module):
        return [q for q in module.parameters() if q.requires_grad]

    stages = [
        ("backbone", backbone, images, params_of(model.backbone), rgb),
        ("fpn", fpn, csets, params_of(model.fpn), None),
        ("cls_head", cls_head, feats, params_of(model.classification_head), None),
        ("reg_head", reg_head, feats, params_of(model.regression_head), None),
        ("loss", loss, heads, [], None),
    ]

    def grad_flops(fn, x):
        """The FLOPs of ``fn``'s forward and backward at ``x`` (counted
        through ``.backward()``: the counter's module hooks refuse
        ``autograd.grad`` on leaf inputs)."""
        xs = [t.detach().requires_grad_(True) for t in _leaves(x)]
        arg = xs[0] if isinstance(x, torch.Tensor) else type(x)(xs)
        with torch.enable_grad():
            flops = benchlib.count_flops(lambda: fn(arg).backward())
        model.zero_grad(set_to_none=True)
        return flops

    def chained_ms(fn, x0):
        return benchlib.time_chained(fn, x0, iters=a.iters, reps=3) / a.iters * 1e3

    rows = []
    for name, fn, x0, params, flop_x in stages:
        fwd = torch.no_grad()(lambda x, fn=fn: _scalar(fn(x)))
        bwd = grad_of(lambda x, fn=fn: _scalar(fn(x)), params)
        t_f, t_g = chained_ms(fwd, x0), chained_ms(bwd, x0)
        fx = x0 if flop_x is None else flop_x
        f_f = benchlib.count_flops(lambda: fwd(fx))
        f_g = grad_flops(lambda x, fn=fn: _scalar(fn(x)), fx)
        row = {"stage": name, "batch": B, "fwd_ms": t_f, "fwd+bwd_ms": t_g,
               "bwd_ms": t_g - t_f, "bwd/fwd": (t_g - t_f) / t_f,
               "differences": ["bwd_ms", "bwd/fwd"]}
        if f_f:                    # the counter counts no op of the loss
            row.update(fwd_tflops=f_f / t_f / 1e9, grad_tflops=f_g / t_g / 1e9,
                       fwd_mfu=f_f / t_f * 1e3 / benchlib.BF16_FLOPS,
                       grad_mfu=f_g / t_g * 1e3 / benchlib.BF16_FLOPS)
        rows.append(benchlib.emit(row, device))

    statics = LossStatics(num_classes=common.NUM_CLASSES)

    def full_loss(x):
        return compute_losses(model, x, boxes, labels, anchors, ILConfig(), FocalConfig(),
                              statics)[0]

    full = grad_of(full_loss, params_of(model))
    t_fg = chained_ms(full, images)
    f_fg = grad_flops(full_loss, rgb)
    benchlib.emit({"stage": "full_grad", "batch": B, "fwd+bwd_ms": t_fg,
                   "grad_tflops": f_fg / t_fg / 1e9,
                   "grad_mfu": f_fg / t_fg * 1e3 / benchlib.BF16_FLOPS,
                   "stage_sum_ms": sum(r["fwd+bwd_ms"] for r in rows),
                   "launches": benchlib.launches_since(before),
                   "seconds": time.perf_counter() - t_start}, device)


if __name__ == "__main__":
    main()
