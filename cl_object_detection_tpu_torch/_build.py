"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` (beside the package, listed in ``.gitignore``),
then loaded with ``ctypes``. The library's file name carries a hash of
its source, of the ``csrc/`` headers it includes (``#include "..."``,
followed through headers) and of its flags, so an edited source or
header is rebuilt and a current one is reused. ``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# per-source extra flags: the NMS and the int8 GEMM's epilogue keep IEEE
# rounding of every multiply and add (no contraction into FMA), so their
# results equal the plain versions' bit for bit
EXTRA_FLAGS: Dict[str, List[str]] = {
    "stem_fused": [],
    "nms_fp": ["--fmad=false"],
    "int8_matmul": ["--fmad=false"],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # wall time of each nvcc run here
build_logs: Dict[str, str] = {}        # nvcc/ptxas output of each build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build from csrc/ at first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header under ``csrc/`` it includes,
    directly or through another header, in the order first met."""
    found: List[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists():
                todo.append(header)
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(BASE_FLAGS + EXTRA_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, target, t0) or
    None when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *BASE_FLAGS, *EXTRA_FLAGS[name], "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, target, t0 = started
    out, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names: Optional[List[str]] = None) -> None:
    """Build every kernel library that is not built yet, one nvcc per
    source, all started together."""
    names = list(EXTRA_FLAGS) if names is None else names
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry of the
    library of ``csrc/<name>.cu`` (which exports
    ``<name>_error_string``)."""
    if status != 0:
        msg = getattr(lib, f"{name}_error_string")(status)
        raise RuntimeError(f"{name}: CUDA error {status}: "
                           f"{msg.decode() if msg else '?'}")
