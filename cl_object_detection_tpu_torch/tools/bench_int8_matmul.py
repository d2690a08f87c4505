"""The int8 kernel against the card's own matmuls at the head convs'
im2col shape (the JAX package's ``tools/bench_int8_matmul.py``, whose
TPU kernel ``_pallas_int8_matmul`` the port's ``ops/int8_matmul.py``
replaces): M = B*H*W of head trunk P4 at B=32, 608x832 (63232), K =
9*256, N = 256.

    python -m cl_object_detection_tpu_torch.tools.bench_int8_matmul [--m 63232] \\
        [--k 2304] [--n 256] [--conv_hw 38 52] [--iters 30] [--cpu]

Records, each from a CUDA graph of ``--iters`` calls on the card
(``utils.benchlib.graph_ms``): a bf16 ``torch.matmul`` (M,K)x(K,N);
``torch._int_mm`` (cuBLASLt int8 -> int32, the product alone); the int8
kernel in GEMM mode (``int8_matmul``: the dequantize epilogue by a filled
scale 1e-4, bf16 out, as the TPU kernel); cuDNN's bf16 3x3 conv of the
NHWC (M / (H*W), H, W, K / 9) activation (``--conv_hw``); the int8 kernel
in conv mode on the same activation (``int8_conv_nhwc``, which gathers
its patches itself: the same M x K x N product). Then the JAX tool's
ratios: the faster of the kernel's two modes against the bf16 matmul,
and its conv mode against cuDNN's bf16 conv.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from ..utils import benchlib
from . import common


def main(argv=None) -> None:
    from ..ops import int8_matmul as im

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--m", type=int, default=63232)    # 32 * 38 * 52: head trunk P4, B=32
    p.add_argument("--k", type=int, default=2304)     # 9 * 256 im2col
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--conv_hw", type=int, nargs=2, default=[38, 52])
    p.add_argument("--iters", type=int, default=30)
    common.add_device_flag(p)
    a = p.parse_args(argv)
    device = common.device_of(a)
    on_card = device.type == "cuda"
    t_start = time.perf_counter()

    m, k, n = a.m, a.k, a.n
    g = torch.Generator(device=device).manual_seed(0)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
    scale = torch.full((n,), 1e-4, device=device)
    xb = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    wb = torch.randn(k, n, generator=g, device=device).to(torch.bfloat16)
    ops = 2.0 * m * k * n

    def timed(fn) -> float:
        return benchlib.graph_ms(fn, iters=a.iters) if on_card else \
            benchlib.host_ms(fn, iters=a.iters, warmup=1)

    def report(tag, ms, peak, extra=None):
        return benchlib.emit({"metric": f"{tag}_m{m}_k{k}_n{n}", "ms": ms,
                              "tflops": ops / ms / 1e9, "of_peak": ops / ms * 1e3 / peak,
                              "peak": peak, **(extra or {})}, device)

    times = {}
    times["bf16_matmul"] = report("matmul_bf16", timed(lambda: torch.matmul(xb, wb)),
                                  benchlib.BF16_FLOPS)["ms"]
    w_kn = w8.t()
    times["int_mm"] = report("matmul_torch_int_mm", timed(lambda: torch._int_mm(x8, w_kn)),
                             benchlib.INT8_OPS)["ms"]
    before = benchlib.launch_counts()
    gemm_ms = timed(lambda: im.int8_matmul(x8, w8, scale))
    times["int8_gemm"] = report("matmul_int8_kernel_gemm", gemm_ms, benchlib.INT8_OPS, {
        "launches": benchlib.launches_since(before)["int8_matmul"],
        "tile_plan": list(im.tile_plan(m, n, k)) if on_card else None})["ms"]

    hc, wc = a.conv_hw
    c = k // 9
    b_img = max(1, m // (hc * wc))
    xc = torch.randn(b_img, c, hc, wc, generator=g, device=device).to(torch.bfloat16)
    xc = xc.contiguous(memory_format=torch.channels_last)
    kc = torch.randn(n, c, 3, 3, generator=g, device=device).to(torch.bfloat16)
    kc = kc.contiguous(memory_format=torch.channels_last)
    conv_ops = 2.0 * b_img * hc * wc * 9 * c * n
    conv_ms = timed(lambda: F.conv2d(xc, kc, padding=1))
    shape = f"b{b_img}_{hc}x{wc}_c{c}_n{n}"
    benchlib.emit({"metric": f"conv3x3_cudnn_bf16_{shape}", "ms": conv_ms,
                   "tflops": conv_ops / conv_ms / 1e9,
                   "of_peak": conv_ops / conv_ms * 1e3 / benchlib.BF16_FLOPS}, device)
    xq = torch.randint(-127, 128, (b_img, hc, wc, c), generator=g, device=device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, 9 * c), generator=g, device=device, dtype=torch.int8)
    before = benchlib.launch_counts()
    conv8_ms = timed(lambda: im.int8_conv_nhwc(xq, wq, scale, kernel=3, stride=1, padding=1))
    launched = benchlib.launches_since(before)["int8_conv_nhwc"]
    benchlib.emit({"metric": f"conv3x3_int8_kernel_conv_{shape}", "ms": conv8_ms,
                   "tflops": conv_ops / conv8_ms / 1e9,
                   "of_peak": conv_ops / conv8_ms * 1e3 / benchlib.INT8_OPS,
                   "launches": launched}, device)
    benchlib.emit({
        "best_int8_kernel_vs_bf16_matmul":
            times["bf16_matmul"] / min(times["int8_gemm"], conv8_ms * ops / conv_ops),
        "int8_kernel_gemm_vs_torch_int_mm": times["int_mm"] / times["int8_gemm"],
        "conv_speedup_int8_vs_bf16": conv_ms / conv8_ms,
        "seconds": time.perf_counter() - t_start}, device)


if __name__ == "__main__":
    main()
