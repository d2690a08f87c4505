"""PyTorch / CUDA port of ``cl_object_detection_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its module layout
and names so each module's counterpart is easy to find. It imports
neither JAX nor the JAX package.

This slice carries the serving path: the RetinaNet forward
(ResNet-18..152 + FPN + heads, with the 4x4 space-to-depth fused stem),
float or int8 (``quantize=True``), logit top-k, decode, clip and
class-aware NMS, behind ``eval.predictor.make_predict_fn`` and
``cli.serve``. Three hand-written CUDA kernels for ``sm_90a`` carry it on
the card: the fused stem (``ops/stem_fused.py`` + ``csrc/stem_fused.cu``),
the batched fixed-point NMS (``ops/nms_fp.py`` + ``csrc/nms_fp.cu``) and
the int8 kernel of the quantized convs, a GEMM that can gather a conv's
patches itself (``ops/int8_matmul.py`` + ``csrc/int8_matmul.cu``, behind
``ops/quant.py``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run "
            "on the CPU")
    return dev
