"""The ResNet backbone's time stage by stage (the JAX package's
``tools/bench_backbone.py``), through the port's own modules
(``models/resnet.py``), each mode a chained run
(``utils.benchlib.time_chained``) on seeded uint8 4x4 space-to-depth
frames:

    python -m cl_object_detection_tpu_torch.tools.bench_backbone [--batch 16] \\
        [--height 640 --width 1024] [--depth 50] [--iters 20] [--cpu] [mode ...]

modes: ``stem`` (normalization + the fused stem kernel: conv, folded
frozen BN, ReLU, max-pool), ``s1`` .. ``s4`` (cumulative through stage
k), ``nobn`` (through s4 with every frozen BN of the stages an identity:
what their elementwise passes cost; the stem's BN is folded into its
kernel and stays), ``f32`` (through s4 in float32: the stem kernel's
float32 form, no TF32). The others run in bfloat16.
"""
from __future__ import annotations

import argparse
import copy
import time

import torch

from ..utils import benchlib
from . import common

MODES = ("stem", "s1", "s2", "s3", "s4", "nobn", "f32")
STAGES = {"stem": 0, "s1": 1, "s2": 2, "s3": 3, "s4": 4, "nobn": 4, "f32": 4}


def make_backbone(depth: int, dtype: torch.dtype, device, bn: bool = True, seed: int = 0):
    """The port's ``ResNetBackbone`` from ``seed``; ``bn=False``: a copy
    whose stage blocks' ``FrozenBN`` modules are identities."""
    from ..models.resnet import FrozenBN, ResNetBackbone

    if dtype == torch.float32:
        common.no_tf32()
    gen = torch.Generator().manual_seed(seed)
    bb = ResNetBackbone(depth, dtype, generator=gen).to(device).eval()
    if not bn:
        bb = copy.deepcopy(bb)
        for names in bb.stage_names:
            for name in names:
                block = getattr(bb, name)
                for child, module in list(block.named_children()):
                    if isinstance(module, FrozenBN):
                        setattr(block, child, torch.nn.Identity())
    return bb


def through(bb, x: torch.Tensor, stages: int) -> torch.Tensor:
    """``bb``'s stem and its first ``stages`` stages on the fused frames
    ``x``, as ``ResNetBackbone.forward`` runs them; NCHW."""
    from ..models.resnet import _device_normalize

    x = _device_normalize(x, bb._norm_mean64, bb._norm_std64, bb.dtype)
    scale, bias = bb._bn_fold()
    x = bb.conv1(x, bn_scale=scale, bn_bias=bias).permute(0, 3, 1, 2)
    for names in bb.stage_names[:stages]:
        for name in names:
            x = getattr(bb, name)(x)
    return x


def run(mode: str, device, batch: int = 16, iters: int = 20, height: int = 640,
        width: int = 1024, depth: int = 50) -> dict:
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    bb = make_backbone(depth, dtype, device, bn=mode != "nobn")
    stages = STAGES[mode]

    @torch.inference_mode()
    def step(x):
        return through(bb, x, stages)[:, 0].float().sum() * 1e-6

    x0 = torch.from_numpy(common.frames(batch, height, width, "fused")).to(device)
    before = benchlib.launch_counts()
    dt = benchlib.time_chained(step, x0, iters=iters, reps=3)
    return {"mode": mode, "batch": batch, "frame": f"{height}x{width}", "depth": depth,
            "ms_per_batch": dt / iters * 1e3, "img_per_s": batch * iters / dt,
            "launches": benchlib.launches_since(before)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("modes", nargs="*", default=["stem", "s1", "s2", "s3", "s4", "nobn"],
                   choices=MODES)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--iters", type=int, default=20)
    common.add_device_flag(p)
    a = p.parse_args(argv)
    device = common.device_of(a)
    for mode in a.modes:
        t0 = time.perf_counter()
        out = run(mode, device, a.batch, a.iters, a.height, a.width, a.depth)
        out["seconds"] = time.perf_counter() - t0
        benchlib.emit(out, device)


if __name__ == "__main__":
    main()
