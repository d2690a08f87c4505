"""Batched greedy-NMS keep masks in one CUDA kernel (``csrc/nms_fp.cu``).

The port of the JAX package's ``ops/nms_pallas.py``
(``nms_pallas_batched``): per image, over k score-sorted class-offset
boxes, the keep mask of greedy hard NMS, bit-identical to
``ops.nms.nms_iterative`` (same IoU division form). ``nms_fp`` takes the
kernel for CUDA tensors and the plain version (``nms_fp_reference``) for
CPU tensors; there is no other fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .nms import nms_iterative

# dynamic shared memory a block may use on sm_90
MAX_SMEM_BYTES = 232448


def smem_bytes(k: int) -> int:
    """Shared memory of one block for k boxes (csrc/nms_fp.cu
    ``smem_bytes``): boxes, areas, two bit rows and the padded k x
    (words+1) suppression bitmask."""
    words = (k + 31) // 32
    return k * 16 + k * 4 + 2 * words * 4 + k * (words + 1) * 4


def max_k() -> int:
    """Largest k whose suppression bitmask fits one block."""
    k = 32
    while smem_bytes(k + 32) <= MAX_SMEM_BYTES:
        k += 32
    return k


def nms_fp_reference(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float = 0.5) -> torch.Tensor:
    """Plain version: (B,k,4), (B,k) -> (B,k) bool keep masks by the
    fixed-point iteration of ``ops.nms.nms_iterative``."""
    return nms_iterative(boxes.float(), scores.float(), iou_thresh)


def nms_fp(boxes: torch.Tensor, scores: torch.Tensor,
           iou_thresh: float = 0.5) -> torch.Tensor:
    """Batched greedy-NMS keep masks (B, k) bool for boxes (B, k, 4)
    sorted by descending score per image and scores (B, k)."""
    if boxes.device.type == "cpu":
        return nms_fp_reference(boxes, scores, iou_thresh)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_fp: unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"nms_fp expects (B,k,4) and (B,k), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    b, k = scores.shape
    if smem_bytes(k) > MAX_SMEM_BYTES:
        raise ValueError(f"k={k} exceeds the kernel's shared-memory "
                         f"capacity (k <= {max_k()})")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(device=boxes.device, dtype=torch.float32).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    lib = _lib()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        status = lib.nms_fp(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                            b, k, float(np.float32(iou_thresh)), stream)
    _build.check(lib, "nms_fp", status)
    nms_fp.launches += 1
    return keep


nms_fp.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("nms_fp")
    if not getattr(lib, "_typed", False):
        lib.nms_fp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_float, ctypes.c_void_p]
        lib.nms_fp.restype = ctypes.c_int
        lib.nms_fp_error_string.argtypes = [ctypes.c_int]
        lib.nms_fp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
