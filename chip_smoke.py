#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The card: its ``nvidia-smi`` name and power limit. No CUDA -> exit 1.
2. Build: ``nvcc`` builds every kernel of the path from ``csrc/`` (one
   process per source, all at once); prints the seconds and ptxas'
   register / shared-memory lines.
3. Kernel checks at the main path's shapes, each against its plain
   PyTorch version on the same inputs on the card:
   * fused stem, bf16, (8,152,208,64) and (32,152,208,64): within 2 bf16
     ulps of |plain| + max|bias| per value (the kernel and cuDNN sum in
     f32 in different orders, which moves the bf16 rounding of the conv
     by at most one ulp before the bias add); float32 input must raise;
   * batched NMS, B=32, k=1024, on random boxes, an IoU-exactly-0.5
     fixture and identical boxes: keep masks bit-identical.
   Times: kernel, plain version, the bound (the larger of bytes over
   3.35 TB/s and operations over the peak rate of their type), and for
   the stem one cuDNN call chain on the equivalent RGB batch.
4. Main path: an R50 RetinaNet, 20 classes, bf16, seeded random weights
   (output convs random and non-zero), 608x832 uint8 fused-stem frames,
   ``nms_impl="pallas_fp"``. After one warm-up request through the serve
   device thread, with the launch counters at 0: the device loop answers
   16 requests from 4 threads at max_batch 8 (their latency printed), then
   ``make_predict_fn`` is timed at B=32 (frames resident on the card).
   Both counters must have risen and the NMS must have seen candidates.
   Output check: finite detections of the static shape, and the fused
   stem path's logits against the RGB (cuDNN stem) path's on 2 frames.
5. One JSON line of the kernels, then the ``{"ok": true, ...}`` line.

``--profile DIR`` adds a torch.profiler window over two B=32 predicts
after phase 4: device time by kernel group, the device's idle share, and
the kernel table in ``DIR/profile_predict.txt``.
"""
from __future__ import annotations

import json
import queue
import subprocess
import sys
import threading
import time

H, W = 608, 832
NUM_CLASSES = 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS = 989e12              # H100 SXM, dense tensor cores
FP32_FLOPS = 67e12               # H100 SXM, outside the tensor cores
NMS_OPS_PER_PAIR = 14            # 4 min/max, 2 sub, 2 clamp, mul, add, sub, max, div, cmp


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

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


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_stem(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    k7 = torch.randn(7, 7, 3, 64, generator=g, device=dev) * 0.05
    k3 = sf.pack_stem_kernel(k7).to(torch.bfloat16)
    bias4 = (torch.randn(64, generator=g, device=dev) * 0.1).repeat(4)
    err = 0.0
    for b in (8, 32):
        x = torch.randn(b, H, W, 3, generator=g, device=dev)
        x4 = torch.zeros(b, H // 4, W // 4, 64, device=dev)
        x4[..., :48] = x.reshape(b, H // 4, 4, W // 4, 4, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, H // 4, W // 4, 48)
        x4 = x4.to(torch.bfloat16)
        got = sf.stem_fused(x4, k3, bias4)
        ref = sf.stem_fused_reference(x4, k3, bias4)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        tol = 2 * bf16_ulp(ref.float().abs() + bias4.abs().max())
        bad = int((diff > tol).sum())
        err = max(err, float(diff.max()))
        log(f"stem B={b}: max_abs_err {float(diff.max()):.6g}, "
            f"values beyond 2 bf16 ulps: {bad} of {diff.numel()}")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"stem kernel disagrees with the plain version at B={b}")
        ms = cuda_ms(lambda: sf.stem_fused(x4, k3, bias4))
        plain_ms = cuda_ms(lambda: sf.stem_fused_reference(x4, k3, bias4))
        rgb = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w7 = k7.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b64 = bias4[:64].to(torch.bfloat16)
        library_ms = cuda_ms(lambda: F.max_pool2d(
            F.relu(F.conv2d(rgb, w7, b64, stride=2, padding=3)), 3, 2, 1))
        m = b * (H // 4) * (W // 4)
        ops = 2.0 * m * 576 * 256
        nbytes = 2 * x4.numel() * 2 + 576 * 256 * 2 + 256 * 4
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        log(f"stem B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN "
            f"conv+bias+relu+pool {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: {ops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        results["stem_fused"] = dict(
            name="stem_fused", route="cuda",
            source="cl_object_detection_tpu_torch/csrc/stem_fused.cu",
            replaces="cl_object_detection_tpu/ops/stem_pallas.py:94",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms, shape=[b, H // 4, W // 4, 64])
    try:
        sf.stem_fused(x4[:1].float(), k3, bias4)
    except TypeError:
        log("stem f32: refused by the wrapper (the kernel takes bf16)")
    else:
        raise AssertionError("stem wrapper accepted float32")


def _nms_inputs(dev):
    import numpy as np
    import torch

    b, k = 32, 1024
    r = np.random.RandomState(3)
    bb = r.rand(b, k, 4).astype(np.float32) * 600
    bb[..., 2:] = bb[..., :2] + 10 + r.rand(b, k, 2).astype(np.float32) * 60
    ss = np.sort(r.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    ss[:, int(k * 0.8):] = 0.0
    # image 0: pairs at IoU exactly 0.5 ([x, x+2] vs [x+2/3, x+2+2/3])
    xs = r.rand(k // 2).astype(np.float32) * 500
    bb[0, 0::2] = np.stack([xs, np.zeros_like(xs), xs + 2, np.ones_like(xs)], 1)
    sh = np.float32(2.0 / 3.0)
    bb[0, 1::2] = bb[0, 0::2] + [sh, 0, sh, 0]
    ss[0] = np.sort(r.rand(k).astype(np.float32))[::-1]
    # image 1: identical boxes, exactly one survives
    bb[1] = np.array([10, 10, 50, 50], np.float32)
    return torch.from_numpy(bb).to(dev), torch.from_numpy(ss).to(dev)


def check_nms(results: dict) -> None:
    import torch

    from cl_object_detection_tpu_torch.ops import nms_fp as nf

    dev = torch.device("cuda")
    boxes, scores = _nms_inputs(dev)
    got = nf.nms_fp(boxes, scores, 0.5)
    ref = nf.nms_fp_reference(boxes, scores, 0.5)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    log(f"nms B=32 k=1024: keep bits differing from the plain version: "
        f"{mismatches}; kept per image {got.sum(1)[:4].tolist()}...")
    if mismatches or int(got[1].sum()) != 1:
        raise AssertionError("nms kernel keep masks differ from the plain version")
    ms = cuda_ms(lambda: nf.nms_fp(boxes, scores, 0.5))
    plain_ms = cuda_ms(lambda: nf.nms_fp_reference(boxes, scores, 0.5), iters=5)
    n_valid = (scores > 0).sum(1).double()
    pairs = float((n_valid * (n_valid - 1) / 2).sum())
    ops = NMS_OPS_PER_PAIR * pairs
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + scores.numel()
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    log(f"nms B=32 k=1024: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(t_ops, t_bytes):.5f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
        f"{pairs:.0f} valid pairs)")
    results["nms_fp"] = dict(
        name="nms_fp", route="cuda",
        source="cl_object_detection_tpu_torch/csrc/nms_fp.cu",
        replaces="cl_object_detection_tpu/ops/nms_pallas.py:48",
        launches=0, max_abs_err=float(mismatches), ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, shape=[32, 1024])


def build_model():
    import math

    import torch

    from cl_object_detection_tpu_torch.config import ModelConfig
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    gen = torch.Generator().manual_seed(0)
    model = create_retinanet(ModelConfig(depth=50, compute_dtype="bfloat16"),
                             NUM_CLASSES, device="cuda", generator=gen)
    with torch.no_grad():
        for head in (model.classification_head, model.regression_head):
            w = head.output.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen).to(w.device) / math.sqrt(fan_in))
    return model


def calibrate_logits(model, frames) -> None:
    """Scale the classifier's output conv so its pre-bias logits have
    std 1.5. The max over 20 classes then clears the 0.05 threshold at
    most anchors despite the prior bias (-4.6), so all k = 1024
    candidates of every image are valid: the NMS works at its full
    size, the heaviest case it meets."""
    import torch

    with torch.inference_mode():
        logits, _ = model(frames, enable_act=False)
    bias = float(model.classification_head.output.bias.detach()[0])
    std = float((logits.float() - bias).std())
    with torch.no_grad():
        model.classification_head.output.weight.mul_(1.5 / std)
    log(f"classifier logit std {std:.4f} before scaling to 1.5")


def make_frames(n: int, seed: int):
    import numpy as np

    r = np.random.RandomState(seed)
    return r.randint(0, 256, (n, H, W, 3)).astype(np.uint8)


def main_path(results: dict, profile_dir: str | None = None) -> float:
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli.serve import (
        device_loop, frame_spec, make_run_predict, submit)
    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
    from cl_object_detection_tpu_torch.ops.nms_fp import nms_fp
    from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused

    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = True
    model = build_model()
    rgb = make_frames(32, 5)
    x4 = space_to_depth(rgb, factor=4)
    frames32 = torch.from_numpy(x4).to(dev)
    calibrate_logits(model, frames32[:2])
    pcfg = PredictConfig(nms_impl="pallas_fp")
    predict = make_predict_fn(model, pcfg)
    run_predict = make_run_predict(predict, dev)
    shape, dtype = frame_spec(H, W, s2d=False, fused=True, uint8=True)
    predict(frames32)                                   # warm-up, B=32
    torch.cuda.synchronize()

    work, stop = queue.Queue(), threading.Event()
    loop = threading.Thread(target=device_loop, args=(work, run_predict, shape, dtype),
                            kwargs=dict(max_batch=8, batch_window_ms=5.0,
                                        request_ttl=300.0, score_thresh=0.3, stop=stop))
    loop.start()
    answers: list = [None] * 16
    latency_ms: list = [0.0] * 16
    try:
        # warm-up through the device thread, as cli.serve does: cuDNN
        # keeps its plans per thread
        warm = submit(work, np.zeros(shape, dtype), 1.0, timeout=300.0)
        if warm is None or "error" in warm:
            raise AssertionError(f"serve warm-up failed: {warm}")

        # ---- main path: counters at 0 -> serve loop -> B=32 predict ----
        stem_fused.launches = 0
        nms_fp.launches = 0
        t0 = time.perf_counter()

        def client(c):
            for j in range(4):
                i = c * 4 + j
                t_req = time.perf_counter()
                answers[i] = submit(work, x4[i], 1.0, timeout=300.0)
                latency_ms[i] = (time.perf_counter() - t_req) * 1e3

        clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("serve client did not finish")
    finally:
        stop.set()
        loop.join(timeout=60)
    serve_s = time.perf_counter() - t0
    if loop.is_alive():
        raise AssertionError("serve device loop did not stop")
    failed = [a for a in answers if a is None or "detections" not in a]
    if failed:
        raise AssertionError(f"{len(failed)} of 16 requests unanswered: {failed[:2]}")
    n_det = sum(len(a["detections"]) for a in answers)
    log(f"serve loop: 16 requests from 4 threads at max_batch 8 answered in "
        f"{serve_s:.3f} s, {n_det} detections above 0.3; launches stem "
        f"{stem_fused.launches}, nms {nms_fp.launches}; request latency ms "
        f"median {float(np.median(latency_ms)):.3f}, max {max(latency_ms):.3f}")
    served = (stem_fused.launches, nms_fp.launches)

    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        det = predict(frames32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ips = 32 * iters / dt
    launches = {"stem_fused": stem_fused.launches, "nms_fp": nms_fp.launches}
    per_predict = {k: (v - s) / iters for (k, v), s in zip(launches.items(), served)}
    log(f"predict B=32 608x832 R50 bf16 fused-stem pallas_fp: {dt / iters * 1e3:.3f} ms "
        f"per batch, {ips:.2f} images/s (frames resident on the card); launches per "
        f"predict {per_predict}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
        results[name]["launches"] = n

    # where the predict time goes: the forward alone, the rest is the
    # post-process (top-k sort, decode, clip, NMS, final top-k)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(frames32, enable_act=False), iters=5, warmup=1)
    batch_ms = dt / iters * 1e3
    log(f"predict B=32 breakdown: forward {fwd_ms:.3f} ms, post-process "
        f"{batch_ms - fwd_ms:.3f} ms (of {batch_ms:.3f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- output checks ----
    if tuple(det.boxes.shape) != (32, pcfg.max_detections, 4):
        raise AssertionError(f"bad detection shape {tuple(det.boxes.shape)}")
    if not (torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()):
        raise AssertionError("non-finite detections")
    if not ((det.labels >= 0) & (det.labels < NUM_CLASSES)).all():
        raise AssertionError("label out of range")
    with torch.inference_mode():
        logits, reg = model(frames32, enable_act=False)
        n_cand = (torch.sigmoid(logits.float().amax(-1)) > pcfg.score_thresh).sum(1)
    log(f"pre-NMS candidates per image (of {logits.shape[1]} anchors): "
        f"min {int(n_cand.min())}, max {int(n_cand.max())}; valid detections per "
        f"image: min {int(det.valid.sum(1).min())}, max {int(det.valid.sum(1).max())}")
    if int(n_cand.min()) < 1 or int(det.valid.sum(1).min()) < 1:
        raise AssertionError("the NMS saw no valid candidates")
    with torch.inference_mode():
        f_cls, f_reg = model(frames32[:2], enable_act=False)
        rgb2 = torch.from_numpy(rgb[:2]).to(dev)
        r_cls, r_reg = model(rgb2, enable_act=False)
    bias = model.classification_head.output.bias.detach()[0]
    rel_cls = float((f_cls - r_cls).norm() / (r_cls - bias).norm())
    rel_reg = float((f_reg - r_reg).norm() / r_reg.norm())
    log(f"fused-stem vs RGB-stem path (bf16, 2 frames): relative L2 error cls "
        f"{rel_cls:.3e}, reg {rel_reg:.3e} (limit 5e-2)")
    if not (rel_cls < 5e-2 and rel_reg < 5e-2):
        raise AssertionError("fused-stem path disagrees with the RGB-stem path")
    if profile_dir:
        profile_predict(predict, frames32, profile_dir)
    return ips


# kernel-name fragments -> the part of the predict path they belong to
_KERNEL_GROUPS = (
    ("stem_fused", ("stem_fused",)),
    ("nms_fp", ("nms_fp",)),
    ("convolution", ("conv", "xmma", "cudnn", "gemm", "cutlass", "implicit")),
    ("sort / top-k", ("sort", "radix", "topk", "scan")),
)


def profile_predict(predict, frames, out_dir: str) -> None:
    """Profile two B=32 predicts with torch.profiler: device time by
    kernel group and the device's idle share over the window; the full
    table goes to ``out_dir/profile_predict.txt``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            predict(frames)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    groups: dict = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in _KERNEL_GROUPS
                      if any(k in name for k in keys)), "elementwise / other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
    log(f"profile, 2 predicts B=32: device busy {busy_us / 2e3:.3f} ms per predict, "
        f"idle share {1 - busy_us / wall_us:.3f} of {wall_us / 2e3:.3f} ms wall "
        "(profiler on)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {us / 2e3:.3f} ms per predict ({us / busy_us:.3f} of device time)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_predict.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60, max_name_column_width=90))


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile the B=32 predict and write the "
                             "kernel table under DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from cl_object_detection_tpu_torch import _build

    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items()) + ")")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    results: dict = {}
    check_stem(results)
    check_nms(results)
    main_path(results, args.profile)

    kernels = []
    for r in results.values():
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
