"""The C++ core of the COCO-protocol evaluator and a CPU greedy NMS
(own copy of the JAX package's ``native/``), built at first use and
loaded with ctypes.

``coco_eval.cpp`` is compiled by ``g++`` (``CXX`` overrides it) into
``build/native/libcocoeval-<hash>.so`` beside the package (listed in
``.gitignore``), under a lock: the hash covers the source and the flags,
so an edited source is rebuilt and a current one reused; the library is
written under a temporary name and renamed into place. There is no
fallback: when the build or the load fails, every entry point raises.
The evaluator's Python path runs only when its caller asks for it
(``CocoProtocolEval.evaluate_class(use_native=False)``).

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "coco_eval.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = os.environ.get("CXX", "g++")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes() + b"\0" + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libcocoeval-{h.hexdigest()[:12]}.so"


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native: cannot run {CXX!r} to build {SRC.name} ({e})") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native: {' '.join(cmd)} failed (exit {out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = lib_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        lib.coco_eval_class.restype = ctypes.c_int
        lib.coco_eval_class.argtypes = [
            ctypes.POINTER(ctypes.c_int),      # det_img
            ctypes.POINTER(ctypes.c_float),    # det_score
            ctypes.POINTER(ctypes.c_float),    # det_box
            ctypes.c_int64,                    # n_det
            ctypes.POINTER(ctypes.c_int),      # gt_img
            ctypes.POINTER(ctypes.c_float),    # gt_box
            ctypes.c_int64,                    # n_gt
            ctypes.c_int,                      # n_imgs
            ctypes.c_int,                      # max_dets
            ctypes.POINTER(ctypes.c_double),   # out[2]
        ]
        lib.greedy_nms.restype = None
        lib.greedy_nms.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def coco_eval_class_native(
    det_img: np.ndarray,      # (N,) int32, image indices 0..n_imgs-1
    det_score: np.ndarray,    # (N,) float32
    det_box: np.ndarray,      # (N, 4) float32 xywh
    gt_img: np.ndarray,       # (M,) int32
    gt_box: np.ndarray,       # (M, 4) float32 xywh
    n_imgs: int,
    max_dets: int = 100,
) -> Tuple[float, float]:
    """(ap50, ar) of one class through the C++ core; (-1, -1) without GT."""
    lib = get_lib()
    det_img = np.ascontiguousarray(det_img, np.int32)
    det_score = np.ascontiguousarray(det_score, np.float32)
    det_box = np.ascontiguousarray(det_box, np.float32)
    gt_img = np.ascontiguousarray(gt_img, np.int32)
    gt_box = np.ascontiguousarray(gt_box, np.float32)
    # the core reads 4 floats per box and one score per detection
    if (det_box.shape != (len(det_img), 4) or det_score.shape != (len(det_img),)
            or gt_box.shape != (len(gt_img), 4)):
        raise ValueError(f"coco_eval_class_native: det_img {det_img.shape}, det_score "
                         f"{det_score.shape}, det_box {det_box.shape}, gt_img "
                         f"{gt_img.shape}, gt_box {gt_box.shape}")
    out = np.zeros(2, np.float64)
    lib.coco_eval_class(
        _ptr(det_img, ctypes.c_int), _ptr(det_score, ctypes.c_float),
        _ptr(det_box, ctypes.c_float), len(det_img),
        _ptr(gt_img, ctypes.c_int), _ptr(gt_box, ctypes.c_float),
        len(gt_img), n_imgs, max_dets, _ptr(out, ctypes.c_double),
    )
    return float(out[0]), float(out[1])


def greedy_nms_native(
    boxes: np.ndarray,        # (n, 4) float32 xyxy, score-desc sorted
    scores: np.ndarray,       # (n,) float32
    iou_thresh: float,
) -> np.ndarray:
    """Keep mask of greedy hard NMS (boxes with score 0 are dropped)."""
    lib = get_lib()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 4 or scores.shape != (len(boxes),):
        raise ValueError(f"greedy_nms_native: boxes {boxes.shape}, scores {scores.shape}")
    keep = np.zeros(len(boxes), np.uint8)
    lib.greedy_nms(
        _ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
        len(boxes), iou_thresh, _ptr(keep, ctypes.c_uint8),
    )
    return keep.astype(bool)
