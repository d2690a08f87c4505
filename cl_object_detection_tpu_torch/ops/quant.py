"""Dynamic int8 quantized inference for the predict path (the JAX
package's ``ops/quant.py``).

Scheme (symmetric post-training quantization, zero point 0), formula for
formula as in JAX:

    s_w[o] = max(max|W[o]|, 1e-8) / 127     per output channel
    s_x    = max(max|x|, 1e-8) / 127        per tensor, over the whole call
    y      = conv(q(x, s_x), q(W, s_w)) * (s_x * s_w) (+ bias)
    q(v, s) = clip(round(v / s), -127, 127) as int8   (round half to even)

PyTorch has no int8 convolution on the card, so a quantized conv is
quantize -> the int8 kernel of ``ops/int8_matmul.py`` (dequantize in its
epilogue), routed by shape:

* a 3x3 conv whose input channels are a multiple of 16:
  ``int8_conv_nhwc``, the kernel's conv mode, which gathers its patches
  from the quantized NHWC activation (no im2col copy);
* a 1x1 conv: ``int8_matmul`` on the (strided) pixels, GEMM mode;
* any other conv: ``im2col`` on the card, then ``int8_matmul``.

``quantized_apply(model)`` runs every ``models.resnet.Conv`` of the model
through ``quantized_conv``, except the ones whose attribute name is in
``exclude_names`` (the heads' ``output`` convs). The stem is a
``StemConv``, not a ``Conv``, and stays float, as in JAX. The switch is a
per-call context variable read by ``Conv.forward``: the model, its
parameters and its state dict are unchanged, and the float and quantized
forwards of one model run side by side, from any thread.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from ..models.resnet import Conv, conv_override
from .int8_matmul import im2col, int8_conv_nhwc, int8_matmul


def _quantize(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(f32(v) / s), -127, 127) as int8 (in place on the
    quotient, a fresh tensor)."""
    return (v.float() / s).round_().clamp_(-127, 127).to(torch.int8)


def quantized_conv(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], *, stride: int, padding: int,
                   dilation: int = 1, groups: int = 1,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 x int8 -> int32 conv with float dequantize.

    ``x`` is NCHW (the port's convs take NCHW views of channels-last
    memory), ``weight`` OIHW float, ``bias`` (O,) or None; returns NCHW
    ``out_dtype`` (default ``x.dtype``) over channels-last memory."""
    if dilation != 1 or groups != 1:
        raise ValueError("quantized_conv takes neither dilation nor groups")
    out_dtype = out_dtype or x.dtype
    o, i, kh, kw = weight.shape
    if kh != kw:
        raise ValueError(f"quantized_conv takes square kernels, got {kh}x{kw}")

    kf = weight.float()
    s_w = torch.clamp_min(kf.abs().amax(dim=(1, 2, 3)), 1e-8) / 127.0
    w_q = _quantize(kf, s_w.view(o, 1, 1, 1))
    w_nk = w_q.permute(0, 2, 3, 1).reshape(o, kh * kw * i)

    # the scale is taken over the whole input (a max is exact in any
    # dtype); a 1x1 strided conv then quantizes only the pixels it reads
    s_x = torch.clamp_min(x.abs().amax().float(), 1e-8) / 127.0
    nhwc = x.permute(0, 2, 3, 1)
    if kh == 1 and padding == 0:
        nhwc, stride = nhwc[:, ::stride, ::stride], 1
    x_q = _quantize(nhwc, s_x)
    scale, b_f = s_x * s_w, None if bias is None else bias.float()
    if kh == 3 and i % 16 == 0:
        y = int8_conv_nhwc(x_q, w_nk, scale, b_f, kernel=3, stride=stride, padding=padding,
                           out_dtype=out_dtype)
    else:
        cols = x_q if kh == 1 and padding == 0 else im2col(x_q, kh, stride, padding)
        b, ho, wo, k = cols.shape
        y = int8_matmul(cols.reshape(b * ho * wo, k), w_nk, scale, b_f,
                        out_dtype).view(b, ho, wo, o)
    return y.permute(0, 3, 1, 2)


def _run_quantized(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    # ``quantized_conv`` (and the wrappers it calls) are looked up per
    # call, so a test can spy on them
    return quantized_conv(x, conv.weight, conv.bias, stride=conv.stride,
                          padding=conv.padding, out_dtype=conv.dtype)


def quantized_apply(model: torch.nn.Module,
                    exclude_names: Sequence[str] = ("output",)) -> Callable:
    """Wrap ``model`` so that every ``Conv`` whose own attribute name is
    not in ``exclude_names`` runs int8. Returns a function with the
    model's call signature; the model itself is not changed."""
    convs = frozenset(m for name, m in model.named_modules()
                      if isinstance(m, Conv)
                      and name.rsplit(".", 1)[-1] not in exclude_names)

    @functools.wraps(model.forward)
    def apply(*args, **kwargs):
        token = conv_override.set((convs, _run_quantized))
        try:
            return model(*args, **kwargs)
        finally:
            conv_override.reset(token)

    return apply
