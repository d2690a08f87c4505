"""The card's published peaks and the least time of each of the
program's kernels at its shapes (the roofline bound: the larger of the
operations over the peak for their type and the bytes over the memory's
bandwidth, each input byte read once and each output byte written once).

Peaks: NVIDIA H100 SXM data sheet, dense tensor-core rates at the 700 W
limit. The kernel formulas are those the repository's ``chip_smoke.py``
uses (``stem_conv_ops``, ``int8_bound``, ``conv_bound``), copied.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from .flops import Conv

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _bound(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def stem_bound_s(batch: int, height: int, width: int) -> float:
    """One launch of the fused bfloat16 stem on ``batch`` frames: the
    7x7/2 conv's operations (3 -> 64 channels at half resolution; the
    packed 3x3 form's zero blocks are not work), and the (B, H/4, W/4, 64)
    bfloat16 input read and output written, the packed (576, 256)
    bfloat16 weight and the 256 float32 biases."""
    ops = 2.0 * batch * (height // 2) * (width // 2) * 7 * 7 * 3 * 64
    frame = batch * (height // 4) * (width // 4) * 64
    nbytes = 2 * frame * 2 + 576 * 256 * 2 + 256 * 4
    return _bound(ops, nbytes, BF16_FLOPS)


def int8_gemm_bound_s(m: int, k: int, n: int) -> float:
    """One int8 GEMM (m x k by k x n) with a bfloat16 output: each operand
    read once, the output written once, the scales and biases."""
    return _bound(2.0 * m * k * n, m * k + n * k + m * n * 2 + 8 * n, INT8_OPS)


def int8_conv_bound_s(batch: int, h: int, w: int, c: int, n: int, m: int) -> float:
    """One int8 3x3 conv in the kernel's conv mode: the NHWC int8 input
    (``batch x h x w x c``) read once, the (n, 9c) weight once, the
    ``m x n`` bfloat16 output written once, the scales and biases."""
    k = 9 * c
    return _bound(2.0 * m * k * n, batch * h * w * c + n * k + m * n * 2 + 8 * n, INT8_OPS)


def int8_launch_bound_s(conv: Conv, batch: int) -> float:
    """The bound of one quantized conv's launch of the int8 kernel, by the
    route the program takes for its shape: conv mode for a 3x3 over a
    multiple of 16 channels, GEMM mode for a 1x1 (on the pixels it reads)."""
    m = batch * conv.hw_out[0] * conv.hw_out[1]
    if conv.k == 3 and conv.cin % 16 == 0:
        return int8_conv_bound_s(batch, conv.hw_in[0], conv.hw_in[1], conv.cin, conv.cout, m)
    return int8_gemm_bound_s(m, conv.cin * conv.k * conv.k, conv.cout)


def int8_predict_bound_s(convs: Iterable[Conv], batch: int) -> Tuple[float, int]:
    """(summed bound, launches) of the int8 kernel over one predict."""
    quantized = [c for c in convs if c.int8]
    return sum(int8_launch_bound_s(c, batch) for c in quantized), len(quantized)
