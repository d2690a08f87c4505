"""int8 x int8 -> int32 GEMM with a per-column dequantize epilogue, in one
CUDA kernel (``csrc/int8_matmul.cu``).

The port of the JAX package's ``tools/bench_int8_matmul.py``
``_pallas_int8_matmul``, which there was the gate experiment for an int8
matmul at the head convs' im2col shapes. Here it is the GEMM of every
quantized conv (``ops/quant.py``)::

    out[m, n] = out_dtype(f32(sum_k x[m, k] * w_nk[n, k]) * scale[n] (+ bias[n]))

with the sum exact in int32. The TPU kernel's case (one scalar scale, no
bias, bf16 out) is a filled ``scale``.

``int8_matmul`` takes the kernel for CUDA tensors and the plain version
(``int8_matmul_reference``) for CPU tensors; there is no other fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

K_MULTIPLE = 64                          # the kernel's K slice, bytes
MAX_K = (2 ** 31 - 1) // (128 * 128)     # |acc| <= K * 128 * 128 fits int32
OUT_DTYPES = (torch.bfloat16, torch.float32)


def _check_args(x, w_nk, scale, bias) -> None:
    if x.dtype != torch.int8 or w_nk.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x.dtype} and {w_nk.dtype}")
    if x.dim() != 2 or w_nk.dim() != 2 or x.shape[1] != w_nk.shape[1]:
        raise ValueError(f"int8_matmul expects (M,K) and (N,K), got "
                         f"{tuple(x.shape)} and {tuple(w_nk.shape)}")
    n = w_nk.shape[0]
    if tuple(scale.shape) != (n,) or (bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"scale and bias must be ({n},), got {tuple(scale.shape)} and "
                         f"{None if bias is None else tuple(bias.shape)}")
    if x.shape[1] > MAX_K:
        raise ValueError(f"K={x.shape[1]} may overflow the int32 sum (K <= {MAX_K})")


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernel's cp.async)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def int8_matmul(x: torch.Tensor, w_nk: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(M,K) int8 x (N,K) int8 -> (M,N) ``out_dtype``, dequantized by the
    float32 ``scale`` (N,) and ``bias`` (N,). A CUDA tensor goes through
    the kernel (bfloat16 or float32 out; K is padded with zeros to a
    multiple of 64), a CPU tensor through ``int8_matmul_reference``."""
    _check_args(x, w_nk, scale, bias)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_nk, scale, bias, out_dtype)
    if x.device.type != "cuda" or w_nk.device != x.device:
        raise ValueError(f"int8_matmul: unsupported devices {x.device} and {w_nk.device}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_matmul kernel writes bfloat16 or float32, not {out_dtype}")
    m, k = x.shape
    n = w_nk.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    pad = -k % K_MULTIPLE
    if pad:
        x, w_nk = F.pad(x, (0, pad)), F.pad(w_nk, (0, pad))
    x, w_nk = _aligned(x), _aligned(w_nk)
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.int8_matmul(x.data_ptr(), w_nk.data_ptr(), scale.data_ptr(),
                                 None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), m, n, k + pad,
                                 int(out_dtype == torch.float32), stream)
    _build.check(lib, "int8_matmul", status)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    if not getattr(lib, "_typed", False):
        lib.int8_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.int8_matmul.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
