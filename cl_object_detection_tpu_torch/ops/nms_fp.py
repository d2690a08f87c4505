"""Batched greedy-NMS keep masks in two CUDA kernels (``csrc/nms_fp.cu``).

The port of the JAX package's ``ops/nms_pallas.py``
(``nms_pallas_batched``): per image, over k score-sorted class-offset
boxes, the keep mask of greedy hard NMS, bit-identical to
``ops.nms.nms_iterative`` (same IoU division form). ``nms_fp`` checks
its arguments and calls the ``cldet::nms_fp`` operator (``ops/library.py``), which takes the
kernel for CUDA tensors and the plain version (``nms_fp_reference``) for
CPU tensors; there is no other fallback.

The kernel takes any k, in two launches on the caller's stream: one
builds every image's suppression bitmask across the card, into a
workspace the wrapper allocates (``workspace_words``: B x k rows of
ceil(k/32) words rounded up to 4, about k^2/8 bytes per image: 4.2 MB
at B=32, k=1024), the other scans it greedily, one warp per image.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import library
from .nms import nms_iterative


def workspace_words(b: int, k: int) -> int:
    """32-bit words of the bitmask workspace for b images of k boxes
    (csrc/nms_fp.cu): k rows per image, each of ceil(k/32) words rounded
    up to a multiple of 4, so that every row starts 16-byte aligned for
    the scan's copies."""
    words = (k + 31) // 32
    return b * k * ((words + 3) // 4 * 4)


def nms_fp_reference(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float = 0.5) -> torch.Tensor:
    """Plain version: (B,k,4), (B,k) -> (B,k) bool keep masks by the
    fixed-point iteration of ``ops.nms.nms_iterative``."""
    return nms_iterative(boxes.float(), scores.float(), iou_thresh)


def _check_shapes(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"nms_fp expects (B,k,4) and (B,k), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")


def nms_fp(boxes: torch.Tensor, scores: torch.Tensor,
           iou_thresh: float = 0.5) -> torch.Tensor:
    """Batched greedy-NMS keep masks (B, k) bool for boxes (B, k, 4)
    sorted by descending score per image and scores (B, k), through the
    ``cldet::nms_fp`` operator (``ops/library.py``): the kernels for CUDA
    tensors, ``nms_fp_reference`` for CPU ones."""
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_fp: unsupported device {boxes.device}")
    _check_shapes(boxes, scores)
    return library.nms_fp(boxes, scores, float(iou_thresh))


def _launch(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """``cldet::nms_fp`` on the card: the mask and scan kernels."""
    _check_shapes(boxes, scores)
    b, k = scores.shape
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(device=boxes.device, dtype=torch.float32).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    work = torch.empty(workspace_words(b, k), dtype=torch.int32, device=boxes.device)
    lib = _lib()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        status = lib.nms_fp(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                            work.data_ptr(), b, k, float(np.float32(iou_thresh)), stream)
    _build.check(lib, "nms_fp", status)
    nms_fp.launches += 1
    return keep


nms_fp.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("nms_fp")
    if not getattr(lib, "_typed", False):
        lib.nms_fp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_float, ctypes.c_void_p]
        lib.nms_fp.restype = ctypes.c_int
        lib.nms_fp_error_string.argtypes = [ctypes.c_int]
        lib.nms_fp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
