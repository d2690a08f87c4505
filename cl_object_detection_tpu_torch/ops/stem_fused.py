"""Fused stem on a 4x4 space-to-depth frame: conv7x7/2 + folded frozen BN
+ ReLU + maxpool3x3/2 in one CUDA kernel (``csrc/stem_fused.cu``).

The port of the JAX package's ``ops/stem_pallas.py``. On the 4x4 grid
the 7x7/2 conv is a 3x3 stride-1 conv with a (3,3,64,256) phase-packed
kernel (``pack_stem_kernel``): output channel (a*2+b)*64+o holds conv
pixel (2I+a, 2J+b, o), and the 3x3/2 pool becomes a shift-only max over
phase blocks (``ops.pool.phase_pool``).

``stem_fused`` takes the kernel for a CUDA tensor and the plain version
(``stem_fused_reference``) for a CPU tensor; there is no other fallback.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .pool import phase_pool


@functools.lru_cache(maxsize=1)
def _pack_tables():
    """Gather indices into the (3,4)-zero-padded 14x14 kernel:
    idx[T,U,al,be,a,b] -> (t+3, u+3) with t = 4(T-1)+al+3-2a (resp. u)."""
    T, U, al, be, a, b = np.meshgrid(
        np.arange(3), np.arange(3), np.arange(4), np.arange(4),
        np.arange(2), np.arange(2), indexing="ij")
    t_idx = 4 * (T - 1) + al + 3 - 2 * a + 3
    u_idx = 4 * (U - 1) + be + 3 - 2 * b + 3
    return t_idx, u_idx


@functools.lru_cache(maxsize=8)
def _pack_index(device: torch.device):
    """The gather indices as tensors on ``device``, copied there once (a
    host-to-device copy per forward would wait for the stream)."""
    return tuple(torch.from_numpy(t).to(device) for t in _pack_tables())


def pack_stem_kernel(k7: torch.Tensor) -> torch.Tensor:
    """(7,7,3,64) HWIO -> (3,3,64,256) phase-packed HWIO kernel
    (pad + gather + permute, differentiable)."""
    wp = F.pad(k7, (0, 0, 0, 0, 3, 4, 3, 4))            # (14,14,3,64)
    t_idx, u_idx = _pack_index(k7.device)
    g = wp[t_idx, u_idx]                               # (T,U,al,be,a,b,3,64)
    g = g.permute(0, 1, 2, 3, 6, 4, 5, 7)             # (T,U,al,be,c,a,b,o)
    k3 = g.reshape(3, 3, 48, 256)
    return F.pad(k3, (0, 0, 0, 16))


def stem_fused_reference(x4: torch.Tensor, k3: torch.Tensor,
                         bias4: torch.Tensor) -> torch.Tensor:
    """Plain version: 3x3/1 conv on the packed NHWC grid + bias + ReLU +
    phase pool, in the dtype of ``x4`` (bias added after the conv's
    output is rounded to that dtype)."""
    w = k3.permute(3, 2, 0, 1).to(x4.dtype)            # OIHW
    y4 = F.conv2d(x4.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    y4 = torch.clamp_min(y4 + bias4.to(y4.dtype), 0)
    return phase_pool(y4)


def stem_fused(x4: torch.Tensor, k3: torch.Tensor,
               bias4: torch.Tensor) -> torch.Tensor:
    """Fused stem on a (B, H/4, W/4, 64) NHWC batch -> pooled
    (B, H/4, W/4, 64). A CUDA tensor goes through the kernel (bfloat16
    only; other dtypes raise), a CPU tensor through
    ``stem_fused_reference``."""
    if x4.device.type == "cpu":
        return stem_fused_reference(x4, k3, bias4)
    if x4.device.type != "cuda":
        raise ValueError(f"stem_fused: unsupported device {x4.device}")
    if x4.dtype != torch.bfloat16:
        raise TypeError(f"stem_fused kernel takes bfloat16, got {x4.dtype}")
    if x4.dim() != 4 or x4.shape[-1] != 64:
        raise ValueError(f"stem_fused expects (B,H4,W4,64), got {tuple(x4.shape)}")
    if tuple(k3.shape) != (3, 3, 64, 256) or bias4.numel() != 256:
        raise ValueError(f"bad stem weights {tuple(k3.shape)} / {tuple(bias4.shape)}")
    x4 = x4.contiguous()
    w = k3.reshape(576, 256).to(device=x4.device, dtype=torch.bfloat16).contiguous()
    b = bias4.reshape(256).to(device=x4.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x4)
    B, H4, W4, _ = x4.shape
    lib = _lib()
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    with torch.cuda.device(x4.device):
        status = lib.stem_fused_bf16(x4.data_ptr(), w.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), B, H4, W4, stream)
    _build.check(lib, "stem_fused", status)
    stem_fused.launches += 1
    return out


stem_fused.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("stem_fused")
    if not getattr(lib, "_typed", False):
        lib.stem_fused_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.stem_fused_bf16.restype = ctypes.c_int
        lib.stem_fused_error_string.argtypes = [ctypes.c_int]
        lib.stem_fused_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
