"""Fused stem on a 4x4 space-to-depth frame: conv7x7/2 + folded frozen BN
+ ReLU + maxpool3x3/2 in one CUDA kernel (``csrc/stem_fused.cu``).

The port of the JAX package's ``ops/stem_pallas.py``. On the 4x4 grid
the 7x7/2 conv is a 3x3 stride-1 conv with a (3,3,64,256) phase-packed
kernel (``pack_stem_kernel``): output channel (a*2+b)*64+o holds conv
pixel (2I+a, 2J+b, o), and the 3x3/2 pool becomes a shift-only max over
phase blocks (``ops.pool.phase_pool``).

Which version runs: the wrappers check their arguments and call the
``cldet::stem_fused_bf16`` and ``cldet::stem_fused_f32`` operators
(``ops/library.py``), whose CPU implementation is
``stem_fused_reference`` and whose CUDA one launches the kernel of the
dtype, or raises. bfloat16 takes the tensor-core kernel (``wgmma``, f32
sums rounded to bf16 as the reference rounds them); float32 takes the
kernel's float32 form on the FMA units (``stem_fused_f32``), since the
tensor cores have no float32 product (only TF32, which would not be
float32). Any other dtype on the card raises ``TypeError``. There is no
fallback on failure.

The float32 form computes the 7x7/2 conv itself, 147 products per
output, not the packed 3x3 conv's 576, so it is exact only for a ``k3``
of ``pack_stem_kernel``'s form. Its contract is a device-side check:
``stem_fused`` on a float32 tensor recovers the 7x7 kernel
(``unpack_stem_kernel``) and asserts, without a host sync, that ``k3``
is ``pack_stem_kernel`` of it. A ``k3`` with a non-zero entry outside
the 7x7 support (or phase blocks that disagree) trips
``torch._assert_async``, which fails the CUDA context at the next
synchronize instead of returning a wrong result (on the CPU it raises
at once); ``torch.export`` keeps the check in the exported program.
The model passes the packed kernel in every dtype, so the dtype decides
the kernel here alone; ``stem_fused_f32``, the float32 form's wrapper,
takes the ``(7,7,3,64)`` kernel (BN scale folded in).

Gradients: ``stem_fused`` is a ``torch.autograd.Function`` (JAX: a
``custom_vjp``). The forward is the dispatch above; the backward
recomputes through ``stem_fused_reference`` at the saved
``(x4, k3, bias4)`` and differentiates that, as JAX's ``_stem_bwd``
does. There is no backward kernel: on the card the backward is cuDNN's
conv backward. So the kernel's output, which the launch writes through
raw pointers, still carries gradients to ``k3`` and ``bias4`` (and from
there to the stem conv's weight and the stem BN's affines).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from . import library
from .pool import phase_pool


def pack_stem_kernel(k7: torch.Tensor) -> torch.Tensor:
    """(7,7,3,64) HWIO -> (3,3,64,256) phase-packed HWIO kernel
    (pad + slices + permute, differentiable): phase block (a, b) of tap
    (T, U) at sub-pixel (al, be) holds k7[4T+al-1-2a, 4U+be-1-2b], zero
    outside the 7x7 support. Pure data movement, so it needs no index
    tensor on the device (nothing cached, nothing for a tracer to
    lift)."""
    wp = F.pad(k7, (0, 0, 0, 0, 3, 4, 3, 4))            # (14,14,3,64)
    # block (a, b) reads rows 4T+al+2-2a and cols 4U+be+2-2b of wp
    g = torch.stack([wp[2 - 2 * a:14 - 2 * a, 2 - 2 * b:14 - 2 * b]
                     for a in range(2) for b in range(2)], dim=-2)  # (12,12,3,4,64)
    g = g.reshape(3, 4, 3, 4, 3, 4, 64)                # (T,al,U,be,c,ab,o)
    k3 = g.permute(0, 2, 1, 3, 4, 5, 6).reshape(3, 3, 48, 256)
    return F.pad(k3, (0, 0, 0, 16))


def unpack_stem_kernel(k3: torch.Tensor) -> torch.Tensor:
    """(3,3,64,256) phase-packed kernel -> the (7,7,3,64) HWIO kernel it
    was packed from (exact when ``k3`` is ``pack_stem_kernel``'s form):
    phase block (0, 0), whose rows 4T+al-1 and cols 4U+be-1 cover the
    whole 7x7 support."""
    g = k3[:, :, :48, :64].reshape(3, 3, 4, 4, 3, 64)    # (T,U,al,be,c,o)
    g = g.permute(0, 2, 1, 3, 4, 5).reshape(12, 12, 3, 64)
    return g[1:8, 1:8].contiguous()


def stem_weight_f32(k7: torch.Tensor) -> torch.Tensor:
    """(7,7,3,64) kernel -> the (147, 64) weight the float32 form loads:
    row (kh*3 + c)*7 + kw, the order of its loop."""
    return k7.permute(0, 2, 1, 3).reshape(147, 64).contiguous()


def stem_fused_reference(x4: torch.Tensor, k3: torch.Tensor,
                         bias4: torch.Tensor) -> torch.Tensor:
    """Plain version: 3x3/1 conv on the packed NHWC grid + bias + ReLU +
    phase pool, in the dtype of ``x4`` (bias added after the conv's
    output is rounded to that dtype)."""
    w = k3.permute(3, 2, 0, 1).to(x4.dtype)            # OIHW
    y4 = F.conv2d(x4.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    # torch.maximum, not clamp_min: its gradient at y == 0 is 0.5, as
    # jnp.maximum's is
    y4 = y4 + bias4.to(y4.dtype)
    return phase_pool(torch.maximum(y4, y4.new_zeros(())))


def stem_weight_kmajor(k3: torch.Tensor) -> torch.Tensor:
    """(3,3,64,256) packed kernel -> the (256, 576) K-major weight the
    kernel loads (in bf16): row n holds output channel n over
    K = (T, U, c), so the 64 channels of tap t = T*3+U are the 128 bytes
    at [t*64, t*64+64)."""
    return k3.reshape(576, 256).t().contiguous()


def _check_frame(x4: torch.Tensor, bias4: torch.Tensor) -> None:
    if x4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_fused: unsupported device {x4.device}")
    if x4.dim() != 4 or x4.shape[-1] != 64:
        raise ValueError(f"stem_fused expects (B,H4,W4,64), got {tuple(x4.shape)}")
    if bias4.numel() != 256:
        raise ValueError(f"bad stem bias {tuple(bias4.shape)}")


def _launch(entry: str, x4: torch.Tensor, w: torch.Tensor,
            bias4: torch.Tensor) -> torch.Tensor:
    x4 = x4.contiguous()
    b = bias4.reshape(256).to(device=x4.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x4)
    B, H4, W4, _ = x4.shape
    lib = _lib()
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    with torch.cuda.device(x4.device):
        status = getattr(lib, entry)(x4.data_ptr(), w.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), B, H4, W4, stream)
    _build.check(lib, "stem_fused", status)
    return out


class _StemFused(torch.autograd.Function):
    """Forward: ``_stem_forward``. Backward: autograd through
    ``stem_fused_reference`` at the saved inputs."""

    @staticmethod
    def forward(ctx, x4, k3, bias4):
        ctx.save_for_backward(x4, k3, bias4)
        return _stem_forward(x4, k3, bias4)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = stem_fused_reference(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def stem_fused(x4: torch.Tensor, k3: torch.Tensor,
               bias4: torch.Tensor) -> torch.Tensor:
    """Fused stem on a (B, H/4, W/4, 64) NHWC batch -> pooled
    (B, H/4, W/4, 64). A float32 batch checks ``k3`` on its device and
    runs the ``cldet::stem_fused_f32`` operator on its 7x7 kernel; any
    other dtype runs ``cldet::stem_fused_bf16`` (``ops/library.py``),
    which on the card launches the tensor-core kernel (counted in
    ``stem_fused.launches``) and takes bfloat16 alone (another dtype
    raises ``TypeError``). On the CPU both operators run
    ``stem_fused_reference``. Differentiable in all three inputs through
    the plain version's backward (module docstring)."""
    return _StemFused.apply(x4, k3, bias4)


def _stem_forward(x4: torch.Tensor, k3: torch.Tensor,
                  bias4: torch.Tensor) -> torch.Tensor:
    _check_frame(x4, bias4)
    if tuple(k3.shape) != (3, 3, 64, 256):
        raise ValueError(f"bad packed stem kernel {tuple(k3.shape)}")
    if x4.dtype == torch.float32:
        k3 = k3.to(device=x4.device, dtype=torch.float32)
        k7 = unpack_stem_kernel(k3)
        # an aten op, so torch.export keeps it in the exported program
        torch._assert_async(torch.eq(pack_stem_kernel(k7), k3).all())
        return library.stem_fused_f32(x4, k7, bias4)
    if x4.device.type == "cuda" and x4.dtype != torch.bfloat16:
        raise TypeError(f"stem_fused on the card takes bfloat16 or float32, got {x4.dtype}")
    return library.stem_fused_bf16(x4, k3, bias4)


def _launch_bf16(x4: torch.Tensor, k3: torch.Tensor, bias4: torch.Tensor) -> torch.Tensor:
    """``cldet::stem_fused_bf16`` on the card: one launch of the
    tensor-core kernel on the K-major weight."""
    _check_frame(x4, bias4)
    if x4.dtype != torch.bfloat16:
        raise TypeError(f"the stem's tensor-core kernel takes bfloat16, got {x4.dtype}")
    w = stem_weight_kmajor(k3.to(device=x4.device, dtype=torch.bfloat16))
    out = _launch("stem_fused_bf16", x4, w, bias4)
    stem_fused.launches += 1
    return out


stem_fused.launches = 0


def stem_fused_f32(x4: torch.Tensor, k7: torch.Tensor,
                   bias4: torch.Tensor) -> torch.Tensor:
    """The float32 form on the 7x7 kernel ``k7`` (7,7,3,64), BN scale
    folded in, through ``cldet::stem_fused_f32``: a float32 CUDA batch
    launches the kernel's FMA form (counted in
    ``stem_fused_f32.launches``), a CPU one runs ``stem_fused_reference``
    on ``pack_stem_kernel(k7)``; another dtype raises ``TypeError``."""
    if x4.dtype != torch.float32:
        raise TypeError(f"stem_fused_f32 takes float32, got {x4.dtype}")
    if tuple(k7.shape) != (7, 7, 3, 64):
        raise ValueError(f"stem_fused_f32 takes the (7,7,3,64) kernel, got {tuple(k7.shape)}")
    _check_frame(x4, bias4)
    return library.stem_fused_f32(x4, k7, bias4)


def _launch_f32(x4: torch.Tensor, k7: torch.Tensor, bias4: torch.Tensor) -> torch.Tensor:
    """``cldet::stem_fused_f32`` on the card: one launch of the FMA form
    on the compact (147, 64) weight."""
    _check_frame(x4, bias4)
    if x4.dtype != torch.float32 or tuple(k7.shape) != (7, 7, 3, 64):
        raise TypeError(f"the stem's float32 form takes a float32 frame and the (7,7,3,64) "
                        f"kernel, got {x4.dtype} and {tuple(k7.shape)}")
    w = stem_weight_f32(k7.to(device=x4.device, dtype=torch.float32))
    out = _launch("stem_fused_f32", x4, w, bias4)
    stem_fused_f32.launches += 1
    return out


stem_fused_f32.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("stem_fused")
    if not getattr(lib, "_typed", False):
        for entry in (lib.stem_fused_bf16, lib.stem_fused_f32):
            entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            entry.restype = ctypes.c_int
        lib.stem_fused_error_string.argtypes = [ctypes.c_int]
        lib.stem_fused_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
