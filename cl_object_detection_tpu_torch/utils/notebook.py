"""Notebook helpers (the JAX package's ``utils/notebook.py``)."""
from __future__ import annotations

import shlex
from typing import List


def text_to_args(text: str) -> List[str]:
    """Flag string -> argv list for driving the CLIs from a notebook:

        from cl_object_detection_tpu_torch.cli import train
        train.main(text_to_args("--scenario 15 1 --distill true --cpu"))
    """
    return shlex.split(text.replace("\n", " "))
