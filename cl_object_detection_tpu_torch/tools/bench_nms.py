"""Latency of the suppression stage alone (the JAX package's
``tools/bench_nms.py``) on k score-sorted candidates, clustered as the
JAX tool makes them (seed 0): the NMS kernel (``pallas_fp``:
``ops.nms_fp.nms_fp``, its mask and scan launches), the fixed-point
form (``iterative``: ``ops.nms.nms_iterative``) and the sequential greedy
loop (``padded``: ``ops.nms.nms_padded``), per image and per batch:

    python -m cl_object_detection_tpu_torch.tools.bench_nms [--k 1024] \\
        [--batch 16] [--iters 20] [--cpu]

On the card the kernel is timed from a CUDA graph of ``--iters`` calls
(``utils.benchlib.graph_ms``: the host's time per call left out); the
other two by CUDA events around ``--iters`` calls, the host's time
included: ``iterative`` asks the host after each fixed-point step
whether it has converged, and ``padded`` makes a threshold tensor from a
host float, neither of which a graph can hold (``padded``'s 1,024 steps
of a few small launches each are bound by the host). The kernel's
records carry its launch count from ``nms_fp.launches``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils import benchlib
from . import common

KINDS = ("pallas_fp", "iterative", "padded")


def candidates(k: int, batch: int, device):
    """(B, k, 4) clustered boxes in a 640x1024 frame and (B, k) scores
    sorted descending, from seed 0 (the JAX tool's draws)."""
    rng = np.random.RandomState(0)
    centers = rng.rand(batch, k, 2) * [1024, 640]
    sizes = 32 + rng.rand(batch, k, 2) * 200
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=2)
    boxes = np.clip(boxes, 0, [1024, 640, 1024, 640]).astype(np.float32)
    scores = np.sort(rng.rand(batch, k), axis=1)[:, ::-1].astype(np.float32)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(np.ascontiguousarray(scores)).to(device))


def bench(kind: str, k: int, batch: int, iters: int, device) -> dict:
    from ..ops.nms import nms_iterative, nms_padded
    from ..ops.nms_fp import nms_fp

    boxes, scores = candidates(k, batch, device)
    fn = {"pallas_fp": nms_fp, "iterative": nms_iterative, "padded": nms_padded}[kind]
    call = lambda: fn(boxes, scores, 0.5)  # noqa: E731
    before = benchlib.launch_counts()
    if torch.device(device).type != "cuda":
        ms, timer = benchlib.host_ms(call, iters=iters, warmup=1), "host clock"
    elif kind == "pallas_fp":
        ms, timer = benchlib.graph_ms(call, iters=iters), "CUDA graph"
    else:
        ms, timer = benchlib.cuda_ms(call, iters=iters), "CUDA events"
    kept = int(call().sum())
    out = {"kind": kind, "k": k, "batch": batch, "value": ms,
           "unit": "ms" if batch == 1 else "ms/batch", "timer": timer, "kept": kept}
    if kind == "pallas_fp":
        out["launches"] = benchlib.launches_since(before)["nms_fp"]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    common.add_device_flag(p)
    a = p.parse_args(argv)
    device = common.device_of(a)
    for batch in (1, a.batch):
        for kind in KINDS:
            t0 = time.perf_counter()
            out = bench(kind, a.k, batch, a.iters, device)
            tag = f"nms_latency_{kind}_k{a.k}" if batch == 1 else \
                f"nms_batched_latency_{kind}_k{a.k}_b{batch}"
            benchlib.emit({"metric": tag, **out, "seconds": time.perf_counter() - t0}, device)


if __name__ == "__main__":
    main()
