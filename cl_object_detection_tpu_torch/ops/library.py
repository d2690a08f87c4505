"""The port's CUDA kernels as ``torch.library`` custom operators
(namespace ``cldet``), so that ``torch.export`` can carry them.

The JAX package's exported StableHLO holds its Pallas kernels inside the
program as custom calls. A kernel of this port launches through
``ctypes`` on ``data_ptr()``, which a tracer's fake tensors do not have,
so every kernel entry point is an operator here, with three
implementations:

* CUDA: the wrapper module's launch (``_launch_*``), which builds the
  kernel at first use (``_build.py``), checks what the kernel takes,
  launches it on the current stream and counts the launch;
* CPU: the kernel's plain version;
* fake: the output's shape, dtype and device, for tracing.

There is no other device: a tensor elsewhere finds no kernel in the
dispatcher, which raises. The operators are defined with
``torch.library.Library`` (schema strings and per-device Python
kernels), not ``torch.library.custom_op``, whose extra Python layers
cost several times as much host time per call, paid at each of the 100
int8 launches of an R50 predict. None of them has a gradient: the
stem's is ``ops.stem_fused._StemFused``, around the operator.

The wrappers (``ops/stem_fused.py``, ``ops/nms_fp.py``,
``ops/int8_matmul.py``) check their arguments and call these operators;
an exported program calls them by name, so a process that loads one
imports this module (``eval/deploy.load_artifact``) and nothing of
``models/``. The implementations import their modules
when first called, which keeps this module's own imports to torch.

``nms_iterative`` is not a kernel: it is ``ops.nms.nms_iterative``, the
fixed-point NMS, whose loop runs until the keep mask stops changing, a
count that depends on the data, which ``torch.export`` cannot trace. An
opaque operator runs that same eager loop at run time on any device, so
the exported program's keep masks are the bytes of the one
implementation the tests hold to JAX's. PyTorch's ``while_loop``
higher-order op would instead need the body rewritten as a traced
subgraph with the predicate as a tensor: a second implementation to
keep equal to the first.
"""
from __future__ import annotations

import torch

NAMESPACE = "cldet"

_lib = torch.library.Library(NAMESPACE, "DEF")


def _define(schema: str, cpu, cuda, fake) -> "torch._ops.OpOverload":
    name = schema.split("(", 1)[0]
    _lib.define(schema)
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# ---- the fused stem (csrc/stem_fused.cu) ----------------------------------

def _stem_bf16_cpu(x4, k3, bias4):
    from .stem_fused import stem_fused_reference

    return stem_fused_reference(x4, k3, bias4).contiguous()


def _stem_bf16_cuda(x4, k3, bias4):
    from .stem_fused import _launch_bf16

    return _launch_bf16(x4, k3, bias4)


def _stem_f32_cpu(x4, k7, bias4):
    from .stem_fused import pack_stem_kernel, stem_fused_reference

    return stem_fused_reference(x4, pack_stem_kernel(k7), bias4).contiguous()


def _stem_f32_cuda(x4, k7, bias4):
    from .stem_fused import _launch_f32

    return _launch_f32(x4, k7, bias4)


def _stem_fake(x4, kernel, bias4):
    return x4.new_empty(x4.shape)


# (B,H/4,W/4,64) frame, the packed (3,3,64,256) kernel, the (256,) bias ->
# the pooled frame; the CPU runs stem_fused_reference in the frame's dtype
stem_fused_bf16 = _define("stem_fused_bf16(Tensor x4, Tensor k3, Tensor bias4) -> Tensor",
                          _stem_bf16_cpu, _stem_bf16_cuda, _stem_fake)
# the float32 form on the (7,7,3,64) kernel; the CPU runs
# stem_fused_reference on pack_stem_kernel(k7)
stem_fused_f32 = _define("stem_fused_f32(Tensor x4, Tensor k7, Tensor bias4) -> Tensor",
                         _stem_f32_cpu, _stem_f32_cuda, _stem_fake)


# ---- the batched NMS (csrc/nms_fp.cu) --------------------------------------

def _nms_fp_cpu(boxes, scores, iou_thresh):
    from .nms_fp import nms_fp_reference

    return nms_fp_reference(boxes, scores, iou_thresh)


def _nms_fp_cuda(boxes, scores, iou_thresh):
    from .nms_fp import _launch

    return _launch(boxes, scores, iou_thresh)


def _nms_iterative(boxes, scores, iou_thresh):
    from .nms import nms_iterative as plain

    return plain(boxes, scores, iou_thresh)


def _keep_fake(boxes, scores, iou_thresh):
    return scores.new_empty(scores.shape, dtype=torch.bool)


# (B,k,4) score-sorted boxes, (B,k) scores -> (B,k) bool greedy-NMS keep
# masks; the CPU runs nms_fp_reference
nms_fp = _define("nms_fp(Tensor boxes, Tensor scores, float iou_thresh) -> Tensor",
                 _nms_fp_cpu, _nms_fp_cuda, _keep_fake)
# ops.nms.nms_iterative on either device (module docstring)
nms_iterative = _define(
    "nms_iterative(Tensor boxes, Tensor scores, float iou_thresh) -> Tensor",
    _nms_iterative, _nms_iterative, _keep_fake)


# ---- the int8 kernel (csrc/int8_matmul.cu), GEMM and conv mode --------------

def _gemm_cpu(x, w_nk, scale, bias, out_dtype):
    from .int8_matmul import int8_matmul_reference

    return int8_matmul_reference(x, w_nk, scale, bias, out_dtype)


def _gemm_cuda(x, w_nk, scale, bias, out_dtype):
    from .int8_matmul import _launch_gemm

    return _launch_gemm(x, w_nk, scale, bias, out_dtype)


def _gemm_fake(x, w_nk, scale, bias, out_dtype):
    return x.new_empty((x.shape[0], w_nk.shape[0]), dtype=out_dtype)


def _conv_cpu(x_q, w_nk, scale, bias, kernel, stride, padding, out_dtype):
    from .int8_matmul import int8_conv_nhwc_reference

    return int8_conv_nhwc_reference(x_q, w_nk, scale, bias, kernel=kernel, stride=stride,
                                    padding=padding, out_dtype=out_dtype)


def _conv_cuda(x_q, w_nk, scale, bias, kernel, stride, padding, out_dtype):
    from .int8_matmul import _launch_conv

    return _launch_conv(x_q, w_nk, scale, bias, kernel, stride, padding, out_dtype)


def _conv_fake(x_q, w_nk, scale, bias, kernel, stride, padding, out_dtype):
    from .int8_matmul import conv_out_hw

    b, h, w, _ = x_q.shape
    ho, wo = conv_out_hw(h, w, kernel, stride, padding)
    return x_q.new_empty((b, ho, wo, w_nk.shape[0]), dtype=out_dtype)


# (M,K) int8 x (N,K) int8 -> (M,N) out_dtype, dequantized by scale and
# bias; the CPU runs int8_matmul_reference
int8_matmul = _define("int8_matmul(Tensor x, Tensor w_nk, Tensor scale, Tensor? bias, "
                      "ScalarType out_dtype) -> Tensor", _gemm_cpu, _gemm_cuda, _gemm_fake)
# square conv of the (B,H,W,C) int8 activation -> (B,Ho,Wo,N) out_dtype;
# the CPU runs int8_conv_nhwc_reference
int8_conv_nhwc = _define("int8_conv_nhwc(Tensor x_q, Tensor w_nk, Tensor scale, Tensor? bias, "
                         "int kernel, int stride, int padding, ScalarType out_dtype) -> Tensor",
                         _conv_cpu, _conv_cuda, _conv_fake)
