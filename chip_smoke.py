#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU and check them.

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
     by at most one ulp before the bias add); float32, (8,152,208,64),
     through the kernel's float32 form (FMA units, the 7x7 conv from the
     compact weight) against the plain version with TF32 off:
     |diff| <= 1e-4 * (1 + |plain|);
   * batched NMS (mask kernel + banded scan), B=32, k=1024 and k=2048,
     on random boxes, an IoU-exactly-0.5 fixture and identical boxes:
     keep masks bit-identical;
   * int8 kernel, GEMM mode (int8 x int8 -> int32, per-column scale,
     optional bias, bf16 out): bit-identical to its plain version at the
     TPU tool's shape (M=62976, K=2304, N=256, scale 1e-4, no bias) and
     at the quantized R50's GEMM shapes; float32 operands must raise;
   * int8 kernel, conv mode (the 3x3 convs of the quantized R50 on their
     NHWC int8 inputs: layer1, layer2 stride 2, head trunk P3, P4 and P7,
     fpn.p6 stride 2): bit-identical to im2col + the plain GEMM.
   Times (the int8 ones from CUDA graphs of 20 calls, which leave out
   the host's time per call; the others per call with it, the NMS also
   from a CUDA graph in the log): kernel, plain version, the bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type; a conv's input counted at its NHWC size; for the stem the
   operations of the 7x7/2 conv it computes, and beside it the bounds of
   the packed 3x3 GEMM and of the operations its 8x16 windows compute,
   halo included), and one library
   call where PyTorch has one (the stem: cuDNN's conv chain on the
   equivalent RGB batch; the int8 kernel: ``torch._int_mm``, the product
   alone, without the dequantize epilogue, on the explicit patches in
   conv mode); conv mode also beside the route it replaced (im2col on
   the card + GEMM mode).
4. Main path: an R50 RetinaNet, 20 classes, bf16, seeded random weights
   (output convs random and non-zero), 608x832 uint8 fused-stem frames,
   ``nms_impl="pallas_fp"``. After one warm-up request through the serve
   device thread, with the launch counters at 0: the device loop answers
   16 requests from 4 threads at max_batch 8 (their latency printed), then
   ``make_predict_fn`` is timed at B=32 (frames resident on the card).
   The stem and NMS counters must have risen (the int8 one must not) and
   the NMS must have seen candidates. Output check: finite detections of
   the static shape, and the fused stem path's logits against the RGB
   (cuDNN stem) path's on 2 frames.
5. Quantized main path (``quantize=True``: every conv but the heads'
   outputs through the int8 GEMM) on the same model and frames, driven
   the same way with the counters at 0 again: 16 served requests, a
   timed B=32 predict beside the float one, its forward/post-process
   split. All counters must have risen, the int8 kernel's by exactly
   100 per R50 predict (52 backbone + 8 FPN + 2 heads x 4 convs x 5
   levels), 61 of them in conv mode (the 16 + 5 + 40 3x3 convs). Output
   check: finite detections of the static shape, and the quantized
   logits against the float ones on 2 frames (correlation > 0.98, the
   bar of the JAX package's tests/test_quant.py).
6. Float32 path: the same R50 built with ``compute_dtype="float32"`` (TF32
   off), counters at 0, three B=8 predicts on the same fused frames. The
   float32 stem kernel and the NMS counters must have risen, the bf16
   stem's and the int8 one's not. Output check: finite detections of the
   static shape, and the fused stem path's logits against the RGB stem
   path's on 2 frames (relative L2 < 1e-3).
7. Train step at state 0 (``train.step.make_train_step``): the bf16 R50
   of phase 4 on 8 of its 608x832 uint8 fused frames with
   tools/bench_train.py's synthetic GT (8 boxes per image, 32 slots),
   ``every_iter=2``, clip 0.1, lr 1e-5. First the stem Function's
   backward at (8,152,208,64) against autograd through the plain version
   (deterministic cuDNN: bit-identical). With the counters at 0: 2
   warm-up micro-steps, then 20 timed ones ending in a synchronise
   (images/s, ms per micro-step, peak memory). The stem counter must
   equal the micro-steps (22), the NMS and int8 ones stay 0; the loss is
   finite at every micro-step; conv1.weight, bn1.weight and bn1.bias
   have moved after the first apply (their gradient goes through the
   kernel's Function). Then the forward / backward / optimizer split
   from CUDA events, one remat micro-step beside a plain one (ms, peak
   memory), and the float32 check: one apply of a small R18 on the card
   (TF32 off, the stem's float32 form under grad) against the same apply
   on the CPU, at the CPU tests' bars.
8. One JSON line of the kernels, then the ``{"ok": true, ...}`` line.

``--profile DIR`` adds a torch.profiler window over two B=32 predicts
after phases 4 and 5 and over two micro-step pairs (two applies) in
phase 7: device time by kernel group, the device's idle share, and the
kernel tables in ``DIR/profile_{predict,predict_int8,train}.txt``.
"""
from __future__ import annotations

import functools
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
INT8_OPS = 1979e12               # H100 SXM, dense tensor cores
NMS_OPS_PER_PAIR = 14            # 4 min/max, 2 sub, 2 clamp, mul, add, sub, max, div, cmp
STEM_OUT = (7, 15)               # pooled outputs of one stem-kernel unit (csrc/stem_fused.cu)
STEM_WINDOW = 8 * 16             # conv pixels the unit computes, the pool's halo included


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


@functools.cache
def _capture_stream():
    """One side stream for every graph capture: cuBLAS keeps a workspace
    for each stream it has run on, so a fresh stream per capture would
    leave memory behind."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so that the host's time per
    call (a wrapper's Python, which can exceed a small kernel's time)
    stays out of the figure. Warmed up on the capture stream first."""
    import torch

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
            f"conv+bias+relu+pool {library_ms:.4f} ms, bound of the packed GEMM "
            f"{max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: {ops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        # the kernel computes 8x16 conv windows for 7x15 pooled outputs
        # (the pool's halo), ragged edges included
        units = b * -(-(H // 4) // STEM_OUT[0]) * -(-(W // 4) // STEM_OUT[1])
        halo = units * STEM_WINDOW / m
        log(f"stem B={b}: bound with the kernel's halo recompute (x{halo:.4f}: {units} "
            f"units of {STEM_WINDOW} conv pixels) {ops * halo / BF16_FLOPS * 1e3:.4f} ms "
            f"(operations: {ops * halo / 1e9:.1f} GFLOP)")
        conv_ops = stem_conv_ops(b)
        conv_bound = conv_ops / BF16_FLOPS * 1e3
        log(f"stem B={b}: bound of the 7x7/2 conv itself (the kernel's bound_ms; the packed "
            f"GEMM's 576 x 256 product is 74% zero blocks) {conv_bound:.4f} ms "
            f"(operations: {conv_ops / 1e9:.1f} GFLOP)")
        results["stem_fused"] = dict(
            name="stem_fused", route="cuda",
            source="cl_object_detection_tpu_torch/csrc/stem_fused.cu",
            replaces="cl_object_detection_tpu/ops/stem_pallas.py:94",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(conv_bound, t_bytes),
            bound_by="operations" if conv_bound >= t_bytes else "bytes",
            library_ms=library_ms, shape=[b, H // 4, W // 4, 64])
    check_stem_f32(results, x[:8], x4[:8].float(), k7, bias4)


def stem_conv_ops(b: int) -> float:
    """Operations of the 7x7/2 conv (3 -> 64 channels) that the stem
    computes, on b frames of H x W."""
    return 2.0 * b * (H // 2) * (W // 2) * 7 * 7 * 3 * 64


def check_stem_f32(results: dict, x, x4, k7, bias4) -> None:
    """The float32 form on the FMA units (the 7x7 conv from the compact
    weight), TF32 off for the plain version and cuDNN. Checked and timed
    through ``stem_fused`` on the packed kernel, as the model calls it
    (the device-side pack check, then the kernel); the kernel's own
    wrapper ``stem_fused_f32`` on the 7x7 kernel is timed beside it."""
    import torch
    import torch.nn.functional as F

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    b = x4.shape[0]
    k3 = sf.pack_stem_kernel(k7)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (sf.stem_fused.launches, sf.stem_fused_f32.launches)
        got = sf.stem_fused(x4, k3, bias4)
        ref = sf.stem_fused_reference(x4, k3, bias4)
        direct = sf.stem_fused_f32(x4, k7, bias4)
        torch.cuda.synchronize()
        if (sf.stem_fused.launches, sf.stem_fused_f32.launches) != (before[0], before[1] + 2):
            raise AssertionError("stem f32 did not launch the float32 form")
        if not torch.equal(direct, got):
            raise AssertionError("stem f32 differs between the packed and the 7x7 entry")
        diff = (got - ref).abs()
        bad = int((diff > 1e-4 * (1 + ref.abs())).sum())
        err = float(diff.max())
        log(f"stem f32 B={b}: max_abs_err {err:.6g}, values beyond 1e-4 * (1 + |plain|): "
            f"{bad} of {diff.numel()}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError("stem f32 kernel disagrees with the plain version")
        ms = cuda_ms(lambda: sf.stem_fused(x4, k3, bias4))
        direct_ms = cuda_ms(lambda: sf.stem_fused_f32(x4, k7, bias4))
        plain_ms = cuda_ms(lambda: sf.stem_fused_reference(x4, k3, bias4))
        rgb = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        w7 = k7.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: F.max_pool2d(
            F.relu(F.conv2d(rgb, w7, bias4[:64], stride=2, padding=3)), 3, 2, 1))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    m = b * (H // 4) * (W // 4)
    packed_ops = 2.0 * m * 576 * 256
    conv_ops = stem_conv_ops(b)
    nbytes = 2 * x4.numel() * 4 + 147 * 64 * 4 + 256 * 4
    t_ops, t_bytes = conv_ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    units = b * -(-(H // 4) // STEM_OUT[0]) * -(-(W // 4) // STEM_OUT[1])
    halo = units * STEM_WINDOW / m
    log(f"stem f32 B={b}: kernel through stem_fused with the device-side pack check "
        f"{ms:.4f} ms, through stem_fused_f32 on the 7x7 kernel {direct_ms:.4f} ms "
        f"({conv_ops / direct_ms / 1e9:.1f} TFLOP/s of the 7x7 conv), plain "
        f"{plain_ms:.4f} ms, cuDNN conv+bias+relu+pool (f32, TF32 off) {library_ms:.4f} ms; "
        f"bound {max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
        f"the 7x7 conv's {conv_ops / 1e9:.1f} GFLOP at the float32 rate, {nbytes / 1e6:.1f} MB); "
        f"with the windows' halo (x{halo:.4f}) {conv_ops * halo / FP32_FLOPS * 1e3:.4f} ms; "
        f"the packed GEMM's {packed_ops / 1e9:.1f} GFLOP {packed_ops / FP32_FLOPS * 1e3:.4f} ms")
    results["stem_fused_f32"] = dict(
        name="stem_fused_f32", route="cuda",
        source="cl_object_detection_tpu_torch/csrc/stem_fused.cu",
        replaces="cl_object_detection_tpu/ops/stem_pallas.py:94",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms, shape=list(x4.shape))


def _nms_inputs(dev, k: int):
    import numpy as np
    import torch

    b = 32
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
    # k = 1024, the main path's, then 2048 (four times the pairs)
    for k in (1024, 2048):
        boxes, scores = _nms_inputs(dev, k)
        got = nf.nms_fp(boxes, scores, 0.5)
        ref = nf.nms_fp_reference(boxes, scores, 0.5)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        log(f"nms B=32 k={k}: keep bits differing from the plain version: "
            f"{mismatches}; kept per image {got.sum(1)[:4].tolist()}...")
        if mismatches or int(got[1].sum()) != 1:
            raise AssertionError(f"nms kernel keep masks differ from the plain version at k={k}")
        ms = cuda_ms(lambda: nf.nms_fp(boxes, scores, 0.5))
        in_graph_ms = graph_ms(lambda: nf.nms_fp(boxes, scores, 0.5))
        plain_ms = cuda_ms(lambda: nf.nms_fp_reference(boxes, scores, 0.5),
                           iters=5 if k <= 1024 else 2, warmup=1)
        n_valid = (scores > 0).sum(1).double()
        pairs = float((n_valid * (n_valid - 1) / 2).sum())
        ops = NMS_OPS_PER_PAIR * pairs
        nbytes = boxes.numel() * 4 + scores.numel() * 4 + scores.numel()
        t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        log(f"nms B=32 k={k}: kernel (mask + scan) {ms:.4f} ms a call with the wrapper's "
            f"host time, {in_graph_ms:.4f} ms from a CUDA graph, plain {plain_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.5f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
            f"{pairs:.0f} valid pairs); workspace {nf.workspace_words(32, k) * 4 / 2**20:.2f} MiB")
        if k == 1024:
            results["nms_fp"] = dict(
                name="nms_fp", route="cuda",
                source="cl_object_detection_tpu_torch/csrc/nms_fp.cu",
                replaces="cl_object_detection_tpu/ops/nms_pallas.py:48",
                launches=0, max_abs_err=float(mismatches), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, shape=[32, 1024])
        del boxes, scores, got, ref


# (name, M, K, N, bias): the TPU tool's shape (its default M = 63232
# rounded down to a multiple of its bm = 512); the im2col GEMMs of five
# 3x3 convs of the quantized R50 predict at 608x832, B=32 (conv mode
# runs those convs on the predict path; the GEMMs stay here as the
# kernel's reference shapes); then the 1x1 convs that GEMM mode runs on
# that path (layer1's expanding and reducing ones, layer3's expanding one)
INT8_SHAPES = (
    ("tool", 62976, 2304, 256, False),
    ("layer1 3x3", 1011712, 576, 64, False),
    ("head trunk P3", 252928, 2304, 256, True),
    ("layer4 3x3", 15808, 4608, 512, False),
    ("fpn.p6", 4160, 18432, 256, True),
    ("head trunk P7", 1120, 2304, 256, True),
    ("layer1 1x1 64->256", 1011712, 64, 256, False),
    ("layer1 1x1 256->64", 1011712, 256, 64, False),
    ("layer3 1x1 256->1024", 63232, 256, 1024, False),
)


def int8_bound(m: int, k: int, n: int):
    """(bound ms, "bytes" or "operations", ops, bytes) of one int8 GEMM
    with bf16 out: each operand read once, the output written once,
    scale and bias."""
    ops = 2.0 * m * k * n
    nbytes = m * k + n * k + m * n * 2 + 8 * n
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


def check_int8_matmul(results: dict) -> None:
    import torch

    from cl_object_detection_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for tag, m, k, n, with_bias in INT8_SHAPES:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        if tag == "tool":
            scale = torch.full((n,), 1e-4, device=dev)
        else:
            scale = torch.rand(n, generator=g, device=dev) * 1e-4
        bias = torch.randn(n, generator=g, device=dev) if with_bias else None
        got = im.int8_matmul(x, w, scale, bias)
        ref = im.int8_matmul_reference(x, w, scale, bias)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
        ms = graph_ms(lambda: im.int8_matmul(x, w, scale, bias))
        w_kn = w.t()                                    # (K,N), K-contiguous
        library_ms = graph_ms(lambda: torch._int_mm(x, w_kn))
        bound, by, ops, nbytes = int8_bound(m, k, n)
        log(f"int8 GEMM {tag} M={m} K={k} N={n}{' +bias' if with_bias else ''}: "
            f"values differing from the plain version: {bad} of {got.numel()}; kernel "
            f"{ms:.4f} ms (tiles, K splits: {im.tile_plan(m, n, k)}), "
            f"{ops / ms / 1e9:.1f} TOP/s; bound {bound:.4f} ms ({by}: {ops / 1e9:.1f} GOP, "
            f"{nbytes / 1e6:.1f} MB); torch._int_mm {library_ms:.4f} ms")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"int8 GEMM disagrees with the plain version at {tag}")
        if tag != "tool":
            continue
        plain_ms = cuda_ms(lambda: im.int8_matmul_reference(x, w, scale, bias), iters=5)
        xb = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        wb = torch.randn(k, n, generator=g, device=dev, dtype=torch.bfloat16)
        bf16_ms = cuda_ms(lambda: torch.matmul(xb, wb))
        log(f"int8 GEMM {tag}: plain {plain_ms:.4f} ms; torch._int_mm (cuBLASLt "
            f"int8 -> int32, the product alone, no dequantize epilogue) "
            f"{library_ms:.4f} ms; bf16 torch.matmul at the same shape {bf16_ms:.4f} ms")
        results["int8_matmul"] = dict(
            name="int8_matmul", route="cuda",
            source="cl_object_detection_tpu_torch/csrc/int8_matmul.cu",
            replaces="tools/bench_int8_matmul.py:28",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=library_ms, shape=[m, k, n])
        del xb, wb
    results["int8_matmul"]["max_abs_err"] = err
    try:
        im.int8_matmul(x.float(), w, scale)
    except TypeError:
        log("int8 GEMM f32 operands: refused by the wrapper (the kernel takes int8)")
    else:
        raise AssertionError("int8 GEMM wrapper accepted float32 operands")


# (name, B, H, W, C, N, stride, bias): the 3x3 convs of the quantized R50
# predict at 608x832, B=32, on their NHWC int8 inputs (padding 1); the
# kernels JSON line carries head trunk P4, the conv the TPU tool's GEMM
# shape stands for (M = 32*38*52 = 63232)
CONV_SHAPES = (
    ("layer1 3x3", 32, 152, 208, 64, 64, 1, False),
    ("layer2 3x3 stride 2", 32, 152, 208, 128, 128, 2, False),
    ("head trunk P3", 32, 76, 104, 256, 256, 1, True),
    ("head trunk P4", 32, 38, 52, 256, 256, 1, True),
    ("fpn.p6 stride 2", 32, 19, 26, 2048, 256, 2, True),
    ("head trunk P7", 32, 5, 7, 256, 256, 1, True),
)


def conv_bound(b: int, h: int, w: int, c: int, n: int, m: int):
    """(bound ms, "bytes" or "operations", ops, bytes) of one int8 3x3
    conv with bf16 out: the NHWC input read once, the weight once, the
    output written once, scale and bias."""
    k = 9 * c
    ops = 2.0 * m * k * n
    nbytes = b * h * w * c + n * k + m * n * 2 + 8 * n
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


def check_int8_conv(results: dict) -> None:
    import torch

    from cl_object_detection_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    err = 0.0
    for tag, b, h, w, c, n, stride, with_bias in CONV_SHAPES:
        x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=dev, dtype=torch.int8)
        wt = torch.randint(-127, 128, (n, 9 * c), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 1e-4
        bias = torch.randn(n, generator=g, device=dev) if with_bias else None
        kw = dict(kernel=3, stride=stride, padding=1)

        def conv():
            return im.int8_conv_nhwc(x, wt, scale, bias, **kw)

        def old_route():                      # im2col on the card + GEMM mode
            cols = im.im2col(x, 3, stride, 1)
            return im.int8_matmul(cols.reshape(-1, 9 * c), wt, scale, bias)

        got = conv()
        ref = im.int8_conv_nhwc_reference(x, wt, scale, bias, **kw)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
        _, ho, wo, _ = got.shape
        m = b * ho * wo
        del ref
        ms = graph_ms(conv)
        old_ms = graph_ms(old_route)
        cols = im.im2col(x, 3, stride, 1).reshape(m, 9 * c)
        w_kn = wt.t()
        library_ms = graph_ms(lambda: torch._int_mm(cols, w_kn))
        bound, by, ops, nbytes = conv_bound(b, h, w, c, n, m)
        log(f"int8 conv {tag} ({b},{h},{w},{c}) -> N={n}{' +bias' if with_bias else ''}: "
            f"values differing from im2col + the plain GEMM: {bad} of {got.numel()}; "
            f"kernel {ms:.4f} ms (tiles, K splits: {im.tile_plan(m, n, 9 * c, True)}), "
            f"{ops / ms / 1e9:.1f} TOP/s; bound {bound:.4f} ms ({by}: {ops / 1e9:.1f} GOP, "
            f"{nbytes / 1e6:.1f} MB); im2col + GEMM mode {old_ms:.4f} ms; torch._int_mm "
            f"on the explicit patches {library_ms:.4f} ms")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"int8 conv disagrees with im2col + the plain GEMM at {tag}")
        if tag == "head trunk P4":
            plain_ms = cuda_ms(lambda: im.int8_conv_nhwc_reference(x, wt, scale, bias, **kw),
                               iters=3, warmup=1)
            log(f"int8 conv {tag}: plain (im2col + float64 product) {plain_ms:.4f} ms")
            results["int8_conv_nhwc"] = dict(
                name="int8_conv_nhwc", route="cuda",
                source="cl_object_detection_tpu_torch/csrc/int8_matmul.cu",
                replaces="tools/bench_int8_matmul.py:28",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape=[b, h, w, c, n])
        del x, wt, got, cols
    results["int8_conv_nhwc"]["max_abs_err"] = err


def build_model(dtype: str = "bfloat16"):
    import math

    import torch

    from cl_object_detection_tpu_torch.config import ModelConfig
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    gen = torch.Generator().manual_seed(0)
    model = create_retinanet(ModelConfig(depth=50, compute_dtype=dtype),
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


def _counters():
    from cl_object_detection_tpu_torch.ops.int8_matmul import int8_conv_nhwc, int8_matmul
    from cl_object_detection_tpu_torch.ops.nms_fp import nms_fp
    from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused, stem_fused_f32

    return {"stem_fused": stem_fused, "stem_fused_f32": stem_fused_f32, "nms_fp": nms_fp,
            "int8_matmul": int8_matmul, "int8_conv_nhwc": int8_conv_nhwc}


def zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def serve_and_time(predict, frames32, x4, tag: str):
    """One path of the smoke: a warm-up request through the serve device
    thread (cuDNN keeps its plans per thread), then, with every launch
    counter at 0, 16 requests from 4 client threads at max_batch 8 and 10
    timed B=32 predicts. Returns (images/s, ms per batch, launch counts
    of the run, launches per timed predict, the last detections)."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli.serve import (
        device_loop, frame_spec, make_run_predict, submit)

    dev = frames32.device
    run_predict = make_run_predict(predict, dev)
    shape, dtype = frame_spec(H, W, s2d=False, fused=True, uint8=True)
    work, stop = queue.Queue(), threading.Event()
    loop = threading.Thread(target=device_loop, args=(work, run_predict, shape, dtype),
                            kwargs=dict(max_batch=8, batch_window_ms=5.0,
                                        request_ttl=300.0, score_thresh=0.3, stop=stop))
    loop.start()
    answers: list = [None] * 16
    latency_ms: list = [0.0] * 16
    try:
        warm = submit(work, np.zeros(shape, dtype), 1.0, timeout=300.0)
        if warm is None or "error" in warm:
            raise AssertionError(f"{tag} serve warm-up failed: {warm}")

        # ---- this path: counters at 0 -> serve loop -> B=32 predict ----
        zero_counts()
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
                raise AssertionError(f"{tag} serve client did not finish")
    finally:
        stop.set()
        loop.join(timeout=60)
    serve_s = time.perf_counter() - t0
    if loop.is_alive():
        raise AssertionError("serve device loop did not stop")
    failed = [a for a in answers if a is None or "detections" not in a]
    if failed:
        raise AssertionError(f"{tag}: {len(failed)} of 16 requests unanswered: {failed[:2]}")
    served = read_counts()
    n_det = sum(len(a["detections"]) for a in answers)
    log(f"{tag} serve loop: 16 requests from 4 threads at max_batch 8 answered in "
        f"{serve_s:.3f} s, {n_det} detections above 0.3; launches {served}; request "
        f"latency ms median {float(np.median(latency_ms)):.3f}, max {max(latency_ms):.3f}")

    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        det = predict(frames32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    per_predict = {k: (v - served[k]) / iters for k, v in counts.items()}
    ips = 32 * iters / dt
    log(f"{tag} predict B=32 608x832 R50 bf16 fused-stem pallas_fp: "
        f"{dt / iters * 1e3:.3f} ms per batch, {ips:.2f} images/s (frames resident "
        f"on the card); launches per predict {per_predict}")
    return ips, dt / iters * 1e3, counts, per_predict, det


def check_detections(det, pcfg, batch: int = 32) -> None:
    import torch

    if tuple(det.boxes.shape) != (batch, pcfg.max_detections, 4):
        raise AssertionError(f"bad detection shape {tuple(det.boxes.shape)}")
    if not (torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()):
        raise AssertionError("non-finite detections")
    if not ((det.labels >= 0) & (det.labels < NUM_CLASSES)).all():
        raise AssertionError("label out of range")
    if int(det.valid.sum(1).min()) < 1:
        raise AssertionError("an image without a valid detection")


def forward_split(apply_fn, frames32, batch_ms: float, tag: str) -> None:
    """Where the predict time goes: the forward alone; the rest is the
    post-process (top-k sort, decode, clip, NMS, final top-k)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: apply_fn(frames32, enable_act=False), iters=5, warmup=1)
    log(f"{tag} predict B=32 breakdown: forward {fwd_ms:.3f} ms, post-process "
        f"{batch_ms - fwd_ms:.3f} ms (of {batch_ms:.3f} ms); peak memory of the "
        f"forward {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main_path(results: dict, profile_dir: str | None = None):
    """The float path (phase 4); returns what the quantized path reuses."""
    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn

    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = True
    model = build_model()
    rgb = make_frames(32, 5)
    x4 = space_to_depth(rgb, factor=4)
    frames32 = torch.from_numpy(x4).to(dev)
    calibrate_logits(model, frames32[:2])
    pcfg = PredictConfig(nms_impl="pallas_fp")
    predict = make_predict_fn(model, pcfg)
    predict(frames32)                                   # warm-up, B=32
    torch.cuda.synchronize()

    ips, batch_ms, counts, _, det = serve_and_time(predict, frames32, x4, "float")
    for name in ("stem_fused", "nms_fp"):
        if counts[name] <= 0:
            raise AssertionError(f"float path never launched {name}")
        results[name]["launches"] = counts[name]
    if counts["int8_matmul"] or counts["int8_conv_nhwc"] or counts["stem_fused_f32"]:
        raise AssertionError("the float path launched the int8 kernel or the f32 stem")
    forward_split(model, frames32, batch_ms, "float")

    # ---- output checks ----
    check_detections(det, pcfg)
    with torch.inference_mode():
        logits, _ = model(frames32, enable_act=False)
        n_cand = (torch.sigmoid(logits.float().amax(-1)) > pcfg.score_thresh).sum(1)
    log(f"pre-NMS candidates per image (of {logits.shape[1]} anchors): "
        f"min {int(n_cand.min())}, max {int(n_cand.max())}; valid detections per "
        f"image: min {int(det.valid.sum(1).min())}, max {int(det.valid.sum(1).max())}")
    if int(n_cand.min()) < 1:
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
        profile_run(lambda: predict(frames32), profile_dir, "profile_predict.txt",
                    "predict B=32")
    return dict(model=model, frames32=frames32, x4=x4, rgb=rgb, ips=ips, f_cls=f_cls)


R50_INT8_GEMMS = 52 + 8 + 2 * 4 * 5     # backbone + FPN + head trunks x levels
R50_INT8_CONVS = 16 + 5 + 2 * 4 * 5     # of them 3x3: backbone + FPN + head trunks


def quantized_path(results: dict, ctx: dict, profile_dir: str | None = None) -> None:
    """The int8 path (phase 5) on the float path's model and frames."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
    from cl_object_detection_tpu_torch.ops.quant import quantized_apply

    model, frames32 = ctx["model"], ctx["frames32"]
    pcfg = PredictConfig(nms_impl="pallas_fp", quantize=True)
    qpredict = make_predict_fn(model, pcfg)
    qpredict(frames32)                                  # warm-up, B=32
    torch.cuda.synchronize()

    ips, batch_ms, counts, per_predict, det = serve_and_time(
        qpredict, frames32, ctx["x4"], "int8")
    for name, n in counts.items():
        if name != "stem_fused_f32" and n <= 0:
            raise AssertionError(f"quantized path never launched {name}")
    if counts["stem_fused_f32"]:
        raise AssertionError("the quantized bf16 path launched the f32 stem")
    if per_predict["int8_matmul"] != R50_INT8_GEMMS:
        raise AssertionError(f"{per_predict['int8_matmul']} int8 launches per R50 predict, "
                             f"not {R50_INT8_GEMMS}: the exclusion is wrong")
    if per_predict["int8_conv_nhwc"] != R50_INT8_CONVS:
        raise AssertionError(f"{per_predict['int8_conv_nhwc']} conv-mode launches per R50 "
                             f"predict, not {R50_INT8_CONVS}: the routing is wrong")
    for name in ("int8_matmul", "int8_conv_nhwc"):
        results[name]["launches"] = counts[name]
    log(f"images/s at B=32: float {ctx['ips']:.2f}, int8 {ips:.2f} "
        f"(int8/float {ips / ctx['ips']:.3f}, same process and card)")
    qapply = quantized_apply(model)
    forward_split(qapply, frames32, batch_ms, "int8")

    # ---- output checks ----
    check_detections(det, pcfg)
    with torch.inference_mode():
        q_cls, _ = qapply(frames32[:2], enable_act=False)
    f = ctx["f_cls"].float().flatten().cpu().numpy()
    q = q_cls.float().flatten().cpu().numpy()
    corr = float(np.corrcoef(f, q)[0, 1])
    bias = float(model.classification_head.output.bias.detach()[0])
    rel = float(np.linalg.norm(q - f) / np.linalg.norm(f - bias))
    log(f"int8 vs float logits (bf16, 2 frames): correlation {corr:.5f} (limit > 0.98), "
        f"relative L2 error {rel:.3e} (of the logits less the prior bias)")
    if not (corr > 0.98 and np.isfinite(q).all()):
        raise AssertionError("quantized logits disagree with the float ones")
    if profile_dir:
        profile_run(lambda: qpredict(frames32), profile_dir, "profile_predict_int8.txt",
                    "predict B=32")


def f32_path(results: dict, ctx: dict) -> None:
    """The float32 model (phase 6) on the float path's frames, TF32 off."""
    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn

    frames = ctx["frames32"][:8]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = build_model("float32")
        calibrate_logits(model, frames[:2])
        pcfg = PredictConfig(nms_impl="pallas_fp")
        predict = make_predict_fn(model, pcfg)
        predict(frames)                                 # warm-up, B=8
        torch.cuda.synchronize()

        # ---- this path: counters at 0 -> three B=8 predicts ----
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            det = predict(frames)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
        counts = read_counts()
        log(f"f32 predict B=8 608x832 R50 float32 fused-stem pallas_fp (TF32 off): "
            f"{dt * 1e3:.3f} ms per batch, {8 / dt:.2f} images/s; launches {counts}")
        if counts["stem_fused_f32"] <= 0 or counts["nms_fp"] <= 0:
            raise AssertionError("the f32 path never launched the f32 stem or the NMS")
        if counts["stem_fused"] or counts["int8_matmul"] or counts["int8_conv_nhwc"]:
            raise AssertionError("the f32 path launched a bf16 or int8 kernel")
        results["stem_fused_f32"]["launches"] = counts["stem_fused_f32"]

        # ---- output checks ----
        check_detections(det, pcfg, batch=8)
        with torch.inference_mode():
            f_cls, f_reg = model(frames[:2], enable_act=False)
            rgb2 = torch.from_numpy(ctx["rgb"][:2]).to(frames.device)
            r_cls, r_reg = model(rgb2, enable_act=False)
        if f_cls.dtype != torch.float32:
            raise AssertionError(f"the f32 model computed in {f_cls.dtype}")
        bias = model.classification_head.output.bias.detach()[0]
        rel_cls = float((f_cls - r_cls).norm() / (r_cls - bias).norm())
        rel_reg = float((f_reg - r_reg).norm() / r_reg.norm())
        log(f"fused-stem vs RGB-stem path (float32, TF32 off, 2 frames): relative L2 "
            f"error cls {rel_cls:.3e}, reg {rel_reg:.3e} (limit 1e-3)")
        if not (rel_cls < 1e-3 and rel_reg < 1e-3):
            raise AssertionError("f32 fused-stem path disagrees with the RGB-stem path")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


TRAIN_B = 8
TRAIN_LR = 1e-5


def synthetic_gt(b: int):
    """tools/bench_train.py's GT: 8 boxes per image in 32 slots, labels
    (image + box) mod the class count."""
    import numpy as np

    boxes = np.full((b, 32, 4), -1, np.float32)
    labels = np.full((b, 32), -1, np.int32)
    for i in range(b):
        for j in range(8):
            x1, y1 = 32 * (j + 1), 16 * (j + 1)
            boxes[i, j] = [x1, y1, x1 + 96, y1 + 64]
            labels[i, j] = (i + j) % NUM_CLASSES
    return boxes, labels


def check_stem_backward(x4) -> None:
    """The stem Function on the train path's (8,152,208,64) bf16 frames:
    the kernel runs the forward, and the backward equals autograd through
    ``stem_fused_reference`` at the same inputs and upstream gradient to
    the bit (cuDNN deterministic for both)."""
    import torch

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    dev = x4.device
    g = torch.Generator(device=dev).manual_seed(7)
    k3 = sf.pack_stem_kernel(torch.randn(7, 7, 3, 64, generator=g, device=dev) * 0.05)
    k3 = k3.to(torch.bfloat16)
    bias4 = (torch.randn(64, generator=g, device=dev) * 0.1).repeat(4)
    up = torch.randn(x4.shape, generator=g, device=dev).to(torch.bfloat16)
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ins = [t.detach().clone().requires_grad_(True) for t in (x4, k3, bias4)]
        before = sf.stem_fused.launches
        out = sf.stem_fused(*ins)
        if sf.stem_fused.launches != before + 1 or out.grad_fn is None:
            raise AssertionError("the stem Function did not launch the kernel under grad")
        got = torch.autograd.grad(out, ins, up)
        ref_ins = [t.detach().clone().requires_grad_(True) for t in (x4, k3, bias4)]
        want = torch.autograd.grad(sf.stem_fused_reference(*ref_ins), ref_ins, up)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    same = [torch.equal(a, b) for a, b in zip(got, want)]

    def through(fn):
        ins = [t.detach().requires_grad_(True) for t in (x4, k3, bias4)]
        return torch.autograd.grad(fn(*ins), ins[1:], up)

    fn_ms = cuda_ms(lambda: through(sf.stem_fused), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: through(sf.stem_fused_reference), iters=10, warmup=2)
    log(f"stem backward B={x4.shape[0]} (x4, k3, bias4): bit-identical to autograd through "
        f"the plain version: {same}; forward + backward to (k3, bias4) {fn_ms:.4f} ms "
        f"through the Function (kernel forward, plain recompute), {plain_ms:.4f} ms "
        f"through the plain version")
    if not all(same):
        raise AssertionError("the stem Function's backward differs from the plain autograd")


def train_path(ctx: dict, profile_dir: str | None = None) -> dict:
    """Phase 7: the train step on the float path's bf16 R50 and frames."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig, ScheduleConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import (
        StepStatics, _clip_by_global_norm, make_train_step)

    model, frames = ctx["model"], ctx["frames32"][:TRAIN_B]
    dev = frames.device
    check_stem_backward(frames.float().div(255.0).to(torch.bfloat16))
    boxes, labels = (torch.from_numpy(a).to(dev) for a in synthetic_gt(TRAIN_B))
    anchors = anchors_for_shape(H, W)
    statics = LossStatics(num_classes=NUM_CLASSES)
    state = TrainState(model, make_optimizer(ScheduleConfig(lr=TRAIN_LR, every_iter=2), model))
    step = make_train_step(model, None, anchors, ILConfig(), FocalConfig(), statics,
                           StepStatics(every_iter=2, grad_clip=0.1))
    bb = model.backbone
    stem_params = {"conv1.weight": bb.conv1.weight, "bn1.weight": bb.bn1.weight,
                   "bn1.bias": bb.bn1.bias}
    before = {k: p.detach().clone() for k, p in stem_params.items()}

    # ---- this path: counters at 0 -> 2 warm-up + 20 timed micro-steps ----
    zero_counts()
    losses = []
    for _ in range(2):
        state, metrics = step(state, frames, boxes, labels)
        losses.append(metrics["total_loss"])
    moved = {k: not torch.equal(before[k], p.detach()) for k, p in stem_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        state, metrics = step(state, frames, boxes, labels)
        losses.append(metrics["total_loss"])
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = torch.stack(losses).float().cpu().numpy()
    ms = dt / iters * 1e3
    ips = TRAIN_B * iters / dt
    log(f"train step R50 bf16 608x832 B={TRAIN_B} every_iter=2 fused-stem: {ms:.3f} ms per "
        f"micro-step (host clock; {start.elapsed_time(end) / iters:.3f} ms by CUDA events), "
        f"{ips:.2f} images/s, peak memory {peak / 2**30:.2f} GiB; launches {counts}; "
        f"total_loss first {loss[0]:.5g}, last {loss[-1]:.5g}; metrics of the last "
        f"micro-step {({k: round(float(v), 6) for k, v in metrics.items()})}")
    log(f"stem parameters moved by the first apply: {moved}")
    if counts["stem_fused"] != 2 + iters:
        raise AssertionError(f"{counts['stem_fused']} stem launches in {2 + iters} micro-steps")
    if any(counts[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul", "int8_conv_nhwc")):
        raise AssertionError("the train path launched another kernel than the bf16 stem")
    if not np.isfinite(loss).all():
        raise AssertionError("non-finite train loss")
    if not all(moved.values()):
        raise AssertionError(f"the first apply did not move every stem parameter: {moved}")

    # ---- where a micro-step's time goes (CUDA events) ----
    anchors_t = torch.from_numpy(anchors.copy()).to(dev)

    def forward():
        with torch.enable_grad():
            return compute_losses(model, frames, boxes, labels, anchors_t, ILConfig(),
                                  FocalConfig(), statics)[0]

    def forward_backward():
        forward().backward()
        model.zero_grad(set_to_none=True)

    fwd_ms = cuda_ms(forward, iters=5, warmup=1)
    fwd_bwd_ms = cuda_ms(forward_backward, iters=5, warmup=1)
    forward().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    clip_ms = cuda_ms(lambda: _clip_by_global_norm(grads, 0.1), iters=10, warmup=2)
    adam_ms = cuda_ms(state.optimizer.step, iters=10, warmup=2)
    model.zero_grad(set_to_none=True)
    log(f"train micro-step split (CUDA events): forward + loss {fwd_ms:.3f} ms, backward "
        f"{fwd_bwd_ms - fwd_ms:.3f} ms, optimizer per apply {clip_ms + adam_ms:.3f} ms (clip "
        f"{clip_ms:.3f}, Adam {adam_ms:.3f}; every second micro-step applies), of "
        f"{ms:.3f} ms per micro-step")

    # ---- one remat micro-step beside a plain one ----
    def one_micro_step():
        """(ms, peak bytes) of one micro-step that does not apply, then
        the applying one of its pair, untimed."""
        nonlocal state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = step(state, frames, boxes, labels)
        e1.record()
        torch.cuda.synchronize()
        out = (e0.elapsed_time(e1), torch.cuda.max_memory_allocated())
        state, _ = step(state, frames, boxes, labels)
        return out

    if state.acc_count != 0:
        raise AssertionError("the timed run ended inside an accumulation")
    plain_ms, plain_peak = one_micro_step()
    bb.remat = True
    try:
        one_micro_step()                                    # warm-up
        remat_ms, remat_peak = one_micro_step()
    finally:
        bb.remat = False
    log(f"remat: one micro-step {remat_ms:.3f} ms, peak {remat_peak / 2**30:.2f} GiB; "
        f"plain {plain_ms:.3f} ms, peak {plain_peak / 2**30:.2f} GiB")
    if profile_dir:
        def pair():
            for _ in range(2):
                step(state, frames, boxes, labels)
        profile_run(pair, profile_dir, "profile_train.txt",
                    f"micro-step pair B={TRAIN_B} (one apply)")
    check_train_f32_small()
    return dict(images_per_s=ips, ms_per_micro_step=ms, forward_ms=fwd_ms,
                backward_ms=fwd_bwd_ms - fwd_ms, clip_ms=clip_ms, adam_ms=adam_ms,
                peak_gib=peak / 2**30, remat_ms=remat_ms, remat_peak_gib=remat_peak / 2**30,
                plain_ms=plain_ms, plain_peak_gib=plain_peak / 2**30,
                stem_launches_per_micro_step=counts["stem_fused"] / (2 + iters))


def check_train_f32_small() -> None:
    """One every_iter=1 apply (clip 0.1, Adam, lr 1e-4) of a float32 R18
    (FPN 32, 2 head layers, 3 classes) on 2 fused 64x96 frames, on the
    card (TF32 off: the stem's float32 form under grad) and on the CPU
    from the same weights: metrics at rtol 1e-4, gradients at
    |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu| per leaf, parameter deltas
    within 1e-3 lr plus one float32 spacing where |g_cpu| >= 1e-3
    max|g_cpu|, everywhere at most lr (1 + 1e-6) plus that spacing."""
    import copy
    import math

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import (
        FocalConfig, ILConfig, ModelConfig, ScheduleConfig)
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.ops import stem_fused as sf
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step

    gen = torch.Generator().manual_seed(11)
    cpu_model = create_retinanet(ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                                             compute_dtype="float32"), 3, device="cpu",
                                 generator=gen)
    with torch.no_grad():
        for head in (cpu_model.classification_head, cpu_model.regression_head):
            w = head.output.weight
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w[0].numel()))
    r = np.random.RandomState(14)
    img = r.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    boxes = np.full((2, 4, 4), -1, np.float32)
    labels = np.full((2, 4), -1, np.int32)
    boxes[0, :2] = [[4, 6, 40, 44], [30, 10, 80, 50]]
    labels[0, :2] = [0, 2]
    boxes[1, 0], labels[1, 0] = [10, 20, 60, 60], 1
    batch_np = (space_to_depth(img, factor=4), boxes, labels)
    anchors = anchors_for_shape(64, 96)
    lr = 1e-4
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    try:
        for device in ("cpu", "cuda"):
            model = copy.deepcopy(cpu_model).to(device)
            batch = tuple(torch.from_numpy(a).to(device) for a in batch_np)
            p0 = {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}
            total, _ = compute_losses(model, *batch,
                                      torch.from_numpy(anchors.copy()).to(device), ILConfig(),
                                      FocalConfig(), LossStatics(num_classes=3))
            total.backward()
            grads = {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            state = TrainState(model, make_optimizer(ScheduleConfig(lr=lr, every_iter=1), model))
            step = make_train_step(model, None, anchors, ILConfig(), FocalConfig(),
                                   LossStatics(num_classes=3),
                                   StepStatics(every_iter=1, grad_clip=0.1))
            before = sf.stem_fused_f32.launches
            state, metrics = step(state, *batch)
            if device == "cuda":
                torch.cuda.synchronize()
                if sf.stem_fused_f32.launches != before + 1:
                    raise AssertionError("the float32 train step did not launch the f32 stem")
            p1 = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
            results.append((grads, {k: float(v) for k, v in metrics.items()},
                            {k: p1[k] - p0[k] for k in p0}, p0))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (g_cpu, m_cpu, d_cpu, p0), (g_dev, m_dev, d_dev, _) = results
    worst_metric = max(abs(m_dev[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    bad_grad = sum(int((np.abs(g_dev[k] - w) > 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).sum())
                   for k, w in g_cpu.items())
    bad_delta = 0
    for k, w in d_cpu.items():
        ulp = np.spacing(np.abs(p0[k]))
        g = np.abs(g_cpu[k])
        sel = g >= 1e-3 * g.max()
        bad_delta += int((np.abs(d_dev[k] - w)[sel] > (1e-3 * lr + ulp)[sel]).sum())
        bad_delta += int((np.abs(d_dev[k]) > lr * (1 + 1e-6) + ulp).sum())
    log(f"train f32 small model, card vs CPU (TF32 off): metrics max relative difference "
        f"{worst_metric:.3g} (limit 1e-4); gradient values beyond their tolerance: {bad_grad}; "
        f"parameter deltas beyond their bars: {bad_delta}")
    if not (worst_metric <= 1e-4 and bad_grad == 0 and bad_delta == 0):
        raise AssertionError("the float32 train step on the card disagrees with the CPU")


# kernel-name fragments -> the part of the predict or train path they belong to
_KERNEL_GROUPS = (
    ("stem_fused", ("stem_fused",)),
    ("nms_fp", ("nms_mask_kernel", "nms_scan_kernel")),
    ("int8 kernel, conv mode", ("int8_matmul_kernel<64, true>", "int8_matmul_kernel<128, true>",
                                "int8_matmul_kernel<256, true>")),
    ("int8 kernel, GEMM mode", ("int8_matmul",)),
    ("foreach (Adam, clip scale, accumulate)", ("multi_tensor",)),
    ("convolution", ("conv", "xmma", "cudnn", "gemm", "cutlass", "implicit", "dgrad", "wgrad")),
    ("sort / top-k", ("sort", "radix", "topk", "scan")),
    ("im2col concatenation", ("catarray",)),
    ("reductions (max |x|)", ("reduce",)),
)


def profile_run(run, out_dir: str, table_name: str, what: str) -> None:
    """Profile two calls of ``run`` (one ``what`` each) with
    torch.profiler: device time by kernel group and the device's idle
    share over the window; the full table goes to
    ``out_dir/table_name``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            run()
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
    log(f"profile {table_name}, 2 x {what}: device busy {busy_us / 2e3:.3f} ms per call, "
        f"idle share {1 - busy_us / wall_us:.3f} of {wall_us / 2e3:.3f} ms wall (profiler on)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {us / 2e3:.3f} ms per call ({us / busy_us:.3f} of device time)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60, max_name_column_width=90))


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile the float and the int8 B=32 "
                             "predicts and the train step, and write their "
                             "kernel tables under DIR")
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
    check_int8_matmul(results)
    check_int8_conv(results)
    ctx = main_path(results, args.profile)
    quantized_path(results, ctx, args.profile)
    f32_path(results, ctx)
    train = train_path(ctx, args.profile)

    kernels = []
    for r in results.values():
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(smi)
    log(json.dumps({"train": train}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
