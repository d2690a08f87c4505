"""Timing helpers shared by the measurement tools (``tools/``) and
``chip_smoke.py`` (the counterpart of the JAX package's
``utils/benchlib.py``).

* ``make_predict_sum`` / ``chain`` / ``time_chained``: a predict (or any
  step) run ``iters`` times in a row, each iteration's input perturbed by
  the previous iteration's result (``x + acc * 1e-12``), so the runs form
  one dependent chain on the device; the host waits once, at the end.
  JAX's module also threads the weights through its chain as arguments
  (``consts``) to work around a limit of its remote compiler; the port's
  steps close over a module and have no such need.
* ``cuda_ms`` (CUDA events around many calls) and ``graph_ms`` (calls
  captured in a CUDA graph, which leaves the host's time per call out),
  ``host_ms`` for the CPU.
* The H100's published peaks (NVIDIA's data sheet, SXM part, dense), the
  card's ``nvidia-smi`` name and power limit that every measured record
  carries, the launch counters of the port's three kernels, a FLOP count
  (``torch.utils.flop_counter``), and the synthetic ground truth of the
  train-step tools.
"""
from __future__ import annotations

import functools
import json
import math
import subprocess
import time
from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS = 989e12              # H100 SXM, dense tensor cores
FP32_FLOPS = 67e12               # H100 SXM, outside the tensor cores
INT8_OPS = 1979e12               # H100 SXM, dense tensor cores

Inputs = Union[torch.Tensor, Sequence[torch.Tensor]]


def smi_line() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@functools.cache
def _card() -> str:
    return smi_line()


def where(device) -> Dict[str, str]:
    """What a measured record says of where it ran: the card's name and
    power limit, or ``{"device": "cpu"}``."""
    if torch.device(device).type == "cuda":
        return {"card": _card()}
    return {"device": "cpu"}


def emit(record: dict, device) -> dict:
    """Print ``record`` with ``where(device)`` as one JSON line; returns it."""
    out = {**record, **where(device)}
    print(json.dumps(out), flush=True)
    return out


def kernel_counters() -> Dict[str, Callable]:
    """The port's kernel wrappers, each counting its launches."""
    from ..ops.int8_matmul import int8_conv_nhwc, int8_matmul
    from ..ops.nms_fp import nms_fp
    from ..ops.stem_fused import stem_fused, stem_fused_f32

    return {"stem_fused": stem_fused, "stem_fused_f32": stem_fused_f32, "nms_fp": nms_fp,
            "int8_matmul": int8_matmul, "int8_conv_nhwc": int8_conv_nhwc}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before = launch_counts()``."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-clock ms per call on the CPU."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def device_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """``cuda_ms`` on the card, ``host_ms`` on the CPU."""
    timer = cuda_ms if torch.device(device).type == "cuda" else host_ms
    return timer(fn, iters=iters, warmup=warmup)


@functools.cache
def _capture_stream():
    """One side stream for every graph capture: cuBLAS keeps a workspace
    for each stream it has run on, so a fresh stream per capture would
    leave memory behind."""
    return torch.cuda.Stream()


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so that the host's time per
    call (a wrapper's Python, which can exceed a small kernel's time)
    stays out of the figure. Warmed up on the capture stream first."""
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_predict_sum(model, anchors: torch.Tensor, pcfg, H: int, W: int):
    """``images -> sum(det.scores)`` (a 0-d float32 tensor on the model's
    device) over the forward and ``ops.nms.detect_batch``, with
    ``pcfg``'s ``nms_impl``, ``topk_method`` and ``quantize``: on the card
    the stem kernel, the NMS kernel under ``nms_impl="pallas_fp"`` and the
    int8 kernel under ``quantize=True``. ``anchors`` is the (A, 4) tensor
    of the ``H`` x ``W`` frame on the model's device."""
    from ..ops.nms import detect_batch
    from ..ops.quant import quantized_apply

    apply_fn = quantized_apply(model) if pcfg.quantize else model

    @torch.inference_mode()
    def predict_sum(images: torch.Tensor) -> torch.Tensor:
        logits, regression = apply_fn(images, enable_act=False)
        det = detect_batch(
            logits, regression, anchors, height=H, width=W,
            score_thresh=pcfg.score_thresh, iou_thresh=pcfg.nms_iou,
            pre_nms_topk=pcfg.pre_nms_topk, max_detections=pcfg.max_detections,
            nms_impl=pcfg.nms_impl, scores_are_logits=True,
            topk_method=pcfg.topk_method)
        return det.scores.float().sum()

    return predict_sum


def _perturb(x: Inputs, acc: torch.Tensor) -> Inputs:
    """``x + acc * 1e-12`` in ``x``'s own dtype (a uint8 frame keeps its
    values), for a tensor or each tensor of a sequence."""
    if isinstance(x, torch.Tensor):
        return (x + acc * 1e-12).to(x.dtype)
    return type(x)(_perturb(t, acc) for t in x)


def _first(x: Inputs) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else _first(x[0])


def chain(step_fn: Callable[[Inputs], torch.Tensor], iters: int):
    """``fn(x) -> acc``: ``step_fn`` run ``iters`` times, each on ``x``
    perturbed by the running sum of the previous results, which it
    returns as a 0-d float32 tensor on ``x``'s device (detached: a step
    under grad keeps no graph across iterations). Nothing in the loop
    waits for the device."""
    def chained(x: Inputs) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=_first(x).device)
        for _ in range(iters):
            acc = acc + step_fn(_perturb(x, acc)).detach().float()
        return acc

    return chained


def time_chained(step_fn, x0: Inputs, iters: int = 20, reps: int = 3) -> float:
    """Mean seconds per chained run of ``iters`` steps, after one warm-up
    run: CUDA events around the ``reps`` runs on the card (one wait, at
    the end), the host clock on the CPU."""
    chained = chain(step_fn, iters)
    chained(x0)
    if _first(x0).device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            chained(x0)
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        chained(x0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def count_flops(fn) -> float:
    """Floating-point operations of one ``fn()`` as
    ``torch.utils.flop_counter`` counts them from the operators' shapes
    (a custom kernel operator counts 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return float(mode.get_total_flops())


def synthetic_gt(b: int, num_classes: int = 20, slots: int = 32):
    """The train-step tools' ground truth (the JAX package's
    ``tools/bench_train.py``): 8 boxes per image in ``slots`` slots,
    labels (image + box) mod ``num_classes``; host numpy."""
    boxes = np.full((b, slots, 4), -1, np.float32)
    labels = np.full((b, slots), -1, np.int32)
    for i in range(b):
        for j in range(8):
            x1, y1 = 32 * (j + 1), 16 * (j + 1)
            boxes[i, j] = [x1, y1, x1 + 96, y1 + 64]
            labels[i, j] = (i + j) % num_classes
    return boxes, labels


def finite_positive(record: dict, differences: Sequence[str] = ()) -> list:
    """The numbers of ``record`` (nested dicts and lists walked) that are
    not finite, or not positive unless their key is in ``differences``
    (a difference of two timings) or is a count; returns their paths."""
    counts = {"batch", "requests", "errors", "concurrency", "workers", "launches",
              "images", "depth", "k", "kept", "iters", "epochs"}
    bad = []

    def walk(node, path, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}", k if key not in counts else key)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]", key)
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            if not math.isfinite(node):
                bad.append(path)
            elif node <= 0 and key not in differences and key not in counts:
                bad.append(path)

    walk(record, "", None)
    return bad
