"""The stem's 3x3/2 pad-1 max-pool over the phase-packed conv layout
(plain torch; the JAX package's ``ops/pool.py``)."""
from __future__ import annotations

import torch


def phase_pool(y4: torch.Tensor) -> torch.Tensor:
    """3x3/2 pad-1 max-pool over a phase-packed NHWC conv output.

    ``y4[..., (a*2+b)*64+o]`` = conv pixel (2i+a, 2j+b, o); pool output
    (i, j) takes conv rows {2i-1, 2i, 2i+1} x cols {2j-1, 2j, 2j+1}. The
    window is separable: a row stage, then a column stage, where row and
    column -1 are -inf.
    """
    a0 = y4[..., 0:128]          # conv row 2i, both column phases
    a1 = y4[..., 128:256]        # conv row 2i+1
    a1_up = torch.cat(
        [torch.full_like(a1[:, :1], float("-inf")), a1[:, :-1]], dim=1)
    ru = torch.maximum(torch.maximum(a0, a1), a1_up)

    b0 = ru[..., 0:64]           # conv col 2j
    b1 = ru[..., 64:128]         # conv col 2j+1
    b1_left = torch.cat(
        [torch.full_like(b1[:, :, :1], float("-inf")), b1[:, :, :-1]], dim=2)
    return torch.maximum(torch.maximum(b0, b1), b1_left)
