"""int8 x int8 -> int32 GEMM, and int8 convolution, with a per-column
dequantize epilogue, in one CUDA kernel (``csrc/int8_matmul.cu``).

The port of the JAX package's ``tools/bench_int8_matmul.py``
``_pallas_int8_matmul``, which there was the gate experiment for an int8
matmul at the head convs' im2col shapes. Here it computes every quantized
conv (``ops/quant.py``)::

    out[m, n] = out_dtype(f32(sum_k a[m, k] * w_nk[n, k]) * scale[n] (+ bias[n]))

with the sum exact in int32, in one of two modes:

* ``int8_matmul``: ``a`` is an (M,K) int8 matrix (a 1x1 conv's pixels);
* ``int8_conv_nhwc``: ``a`` is the patch matrix of a square conv over an
  NHWC int8 activation, which the kernel gathers itself (JAX's
  ``lax.conv_general_dilated`` on s8 x s8 -> s32; no im2col copy).

The TPU kernel's case (one scalar scale, no bias, bf16 out) is a filled
``scale``. Each wrapper checks its arguments and calls its
``torch.library`` operator (``cldet::int8_matmul``,
``cldet::int8_conv_nhwc``; ``ops/library.py``), which takes the kernel
for CUDA tensors and its plain version (``int8_matmul_reference``,
``int8_conv_nhwc_reference``) for CPU tensors; there is no other
fallback. ``int8_matmul.launches`` counts the
kernel's launches in both modes, ``int8_conv_nhwc.launches`` those in
conv mode.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from . import library

K_MULTIPLE = 64                          # GEMM mode pads K to this (the kernel takes 16)
K_SLICE = 128                            # the kernel's K slice per pipeline stage, bytes
BLOCK_M = 128                            # rows of a tile
MAX_K = (2 ** 31 - 1) // (128 * 128)     # |acc| <= K * 128 * 128 fits int32
OUT_DTYPES = (torch.bfloat16, torch.float32)
H100_SMS = 132


def tile_plan(m: int, n: int, k: int, conv: bool = False,
              sms: int = H100_SMS) -> Tuple[int, int]:
    """(BN, K splits) of one launch, by shape.

    BN follows N: 64 for N <= 64, else 128; in conv mode 256 for N > 128,
    since each N tile gathers the patches anew (GEMM mode's TMA reloads A
    from L2 instead, and 128 keeps it more stages in flight). When the
    tiles would fill at most half the SMs, BN halves down to 64 (to 128
    for a K of 64 slices or more); then, for such a long K, the K splits
    double while the tiles fill at most half the SMs and each split keeps
    32 slices or more."""
    bn = 64 if n <= 64 else 256 if conv and n > 128 else 128
    tiles_m = -(-m // BLOCK_M)
    k_slices = -(-k // K_SLICE)
    long_k = k_slices >= 64
    while bn > (128 if long_k else 64) and tiles_m * -(-n // bn) * 2 <= sms:
        bn //= 2
    tiles = tiles_m * -(-n // bn)
    splits = 1
    while long_k and tiles * splits * 2 <= sms and k_slices >= 64 * splits:
        splits *= 2
    return bn, splits


def _check_args(x, w_nk, scale, bias, k: int) -> None:
    """int8 operands, an (N,k) weight, (N,) scale and bias, and a K that
    cannot overflow the int32 sum."""
    if x.dtype != torch.int8 or w_nk.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x.dtype} and {w_nk.dtype}")
    if w_nk.dim() != 2 or w_nk.shape[1] != k:
        raise ValueError(f"the weight must be (N,{k}), got {tuple(w_nk.shape)} "
                         f"for an input of shape {tuple(x.shape)}")
    n = w_nk.shape[0]
    if tuple(scale.shape) != (n,) or (bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"scale and bias must be ({n},), got {tuple(scale.shape)} and "
                         f"{None if bias is None else tuple(bias.shape)}")
    if k > MAX_K:
        raise ValueError(f"K={k} may overflow the int32 sum (K <= {MAX_K})")


def int8_matmul_reference(x: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: the int32 product through a float64 matmul (exact,
    since |acc| < 2**53), then the kernel's float32 epilogue (the float64
    -> float32 cast rounds as the kernel's int -> float32 does)."""
    acc = torch.matmul(x.double(), w_nk.double().t())
    y = acc.float() * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def im2col(x_q: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """(B,H,W,C) int8 -> (B,Ho,Wo,kernel*kernel*C) patches, K ordered
    (kh, kw, c): a strided view for a 1x1 conv without padding, else zero
    padding and kernel*kernel shifted strided views side by side."""
    if kernel == 1 and padding == 0:
        return x_q[:, ::stride, ::stride]
    b, h, w, c = x_q.shape
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    xp = F.pad(x_q, (0, 0, padding, padding, padding, padding))
    return torch.cat([xp[:, i:i + stride * (ho - 1) + 1:stride,
                         j:j + stride * (wo - 1) + 1:stride]
                      for i in range(kernel) for j in range(kernel)], dim=3)


def int8_conv_nhwc_reference(x_q: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *, kernel: int,
                             stride: int, padding: int,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of conv mode: ``im2col``, then
    ``int8_matmul_reference``; (B,Ho,Wo,N)."""
    cols = im2col(x_q, kernel, stride, padding)
    b, ho, wo, k = cols.shape
    y = int8_matmul_reference(cols.reshape(b * ho * wo, k), w_nk, scale, bias, out_dtype)
    return y.view(b, ho, wo, -1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (TMA and cp.async)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _epilogue_args(scale, bias, device):
    scale = scale.to(device=device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=device, dtype=torch.float32).contiguous()
    return scale, bias


def _launch_args(m: int, n: int, k: int, conv: bool, device):
    """(BN, splits, the zeroed int32 partial sums or None) of a launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bn, splits = tile_plan(m, n, k, conv, sms)
    partial = torch.zeros((m, n), dtype=torch.int32, device=device) if splits > 1 else None
    return bn, splits, partial


def int8_matmul(x: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(M,K) int8 x (N,K) int8 -> (M,N) ``out_dtype``, dequantized by the
    float32 ``scale`` (N,) and ``bias`` (N,), through the
    ``cldet::int8_matmul`` operator (``ops/library.py``). A CUDA tensor
    goes through the kernel (bfloat16 or float32 out; K is padded with
    zeros to a multiple of 64), a CPU tensor through
    ``int8_matmul_reference``."""
    if x.dim() != 2:
        raise ValueError(f"int8_matmul expects (M,K) and (N,K), got {tuple(x.shape)}")
    _check_args(x, w_nk, scale, bias, x.shape[1])
    if x.device.type == "cuda":
        _check_card(x, w_nk, out_dtype, "int8_matmul")
    elif x.device.type != "cpu":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return library.int8_matmul(x, w_nk, scale, bias, out_dtype)


def _check_card(x, w_nk, out_dtype, name: str) -> None:
    """What the kernel takes beyond the plain version: both operands on
    the card, and a bfloat16 or float32 output."""
    if x.device.type != "cuda" or w_nk.device != x.device:
        raise ValueError(f"{name}: unsupported devices {x.device} and {w_nk.device}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name} kernel writes bfloat16 or float32, not {out_dtype}")


def _launch_gemm(x: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """``cldet::int8_matmul`` on the card: one launch in GEMM mode."""
    _check_args(x, w_nk, scale, bias, x.shape[1])
    _check_card(x, w_nk, out_dtype, "int8_matmul")
    m, k = x.shape
    n = w_nk.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    pad = -k % K_MULTIPLE
    if pad:
        x, w_nk = F.pad(x, (0, pad)), F.pad(w_nk, (0, pad))
    x, w_nk = _aligned(x), _aligned(w_nk)
    scale, bias = _epilogue_args(scale, bias, x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        bn, splits, partial = _launch_args(m, n, k + pad, False, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.int8_matmul(x.data_ptr(), w_nk.data_ptr(), scale.data_ptr(),
                                 None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), m, n, k + pad,
                                 int(out_dtype == torch.float32), bn, splits,
                                 None if partial is None else partial.data_ptr(), stream)
    _build.check(lib, "int8_matmul", status)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def conv_out_hw(h: int, w: int, kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    """(Ho, Wo) of a square conv."""
    return ((h + 2 * padding - kernel) // stride + 1,
            (w + 2 * padding - kernel) // stride + 1)


def _check_conv(x_q, w_nk, scale, bias, kernel: int, stride: int, padding: int) -> None:
    if x_q.dim() != 4:
        raise ValueError(f"int8_conv_nhwc expects (B,H,W,C), got {tuple(x_q.shape)}")
    b, h, w, c = x_q.shape
    if kernel < 1 or stride < 1 or padding < 0:
        raise ValueError(f"bad conv: kernel {kernel}, stride {stride}, padding {padding}")
    ho, wo = conv_out_hw(h, w, kernel, stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv_nhwc: a {kernel}x{kernel} kernel does not fit "
                         f"{h}x{w} with padding {padding}")
    _check_args(x_q, w_nk, scale, bias, kernel * kernel * c)


def int8_conv_nhwc(x_q: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, kernel: int, stride: int,
                   padding: int, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Square ``kernel`` x ``kernel`` conv of the (B,H,W,C) int8 activation
    ``x_q`` with the (N, kernel*kernel*C) int8 weight ``w_nk`` ((kh, kw, c)
    order), zero padding ``padding``, -> (B,Ho,Wo,N) ``out_dtype``
    dequantized by ``scale`` and ``bias``, through the
    ``cldet::int8_conv_nhwc`` operator (``ops/library.py``). A CUDA
    tensor goes through the kernel in conv mode (C a multiple of 16),
    which gathers its patches from ``x_q``; a CPU tensor through
    ``int8_conv_nhwc_reference``."""
    _check_conv(x_q, w_nk, scale, bias, kernel, stride, padding)
    if x_q.device.type == "cuda":
        _check_card(x_q, w_nk, out_dtype, "int8_conv_nhwc")
        if x_q.shape[-1] % 16:
            raise ValueError(f"int8_conv_nhwc kernel takes C a multiple of 16, "
                             f"got {x_q.shape[-1]}")
    elif x_q.device.type != "cpu":
        raise ValueError(f"int8_conv_nhwc: unsupported device {x_q.device}")
    return library.int8_conv_nhwc(x_q, w_nk, scale, bias, kernel, stride, padding, out_dtype)


def _launch_conv(x_q: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], kernel: int, stride: int, padding: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``cldet::int8_conv_nhwc`` on the card: one launch in conv mode."""
    _check_conv(x_q, w_nk, scale, bias, kernel, stride, padding)
    _check_card(x_q, w_nk, out_dtype, "int8_conv_nhwc")
    b, h, w, c = x_q.shape
    if c % 16:
        raise ValueError(f"int8_conv_nhwc kernel takes C a multiple of 16, got {c}")
    ho, wo = conv_out_hw(h, w, kernel, stride, padding)
    n = w_nk.shape[0]
    out = torch.empty((b, ho, wo, n), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    x_q, w_nk = _aligned(x_q), _aligned(w_nk)
    scale, bias = _epilogue_args(scale, bias, x_q.device)
    lib = _lib()
    with torch.cuda.device(x_q.device):
        bn, splits, partial = _launch_args(b * ho * wo, n, kernel * kernel * c, True,
                                           x_q.device)
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        status = lib.int8_conv_nhwc(x_q.data_ptr(), w_nk.data_ptr(), scale.data_ptr(),
                                    None if bias is None else bias.data_ptr(),
                                    out.data_ptr(), b, h, w, c, n, kernel, stride, padding,
                                    int(out_dtype == torch.float32), bn, splits,
                                    None if partial is None else partial.data_ptr(), stream)
    _build.check(lib, "int8_matmul", status)
    int8_matmul.launches += 1
    int8_conv_nhwc.launches += 1
    return out


int8_conv_nhwc.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    if not getattr(lib, "_typed", False):
        lib.int8_matmul.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p] * 2)
        lib.int8_matmul.restype = ctypes.c_int
        lib.int8_conv_nhwc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                                       + [ctypes.c_void_p] * 2)
        lib.int8_conv_nhwc.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
