"""A-GEM: the averaged replay gradient (the JAX package's ``il/agem.py``).

A full pass over the replay loader computes the gradient of the plain
(replay-path) loss per batch, clips it to global norm 0.1
(``scale = min(1, 0.1 / max(||g||, 1e-6))``, the BN leaves counted in
the norm), zeroes the frozen-BN leaves (every module named ``bn*``; the
downsample BN affines stay in, as in JAX) and adds it divided by the
number of batches. The train step projects each update against the
result (``train.step._agem_project``), which it reads by parameter name.

The gradients come from ``torch.autograd.grad`` into fresh tensors, so
the pass leaves the train step's accumulator (the parameters' ``.grad``)
untouched. ``AGEMConfig.refresh_every`` (in ``train/loop.py``) sets how
often the pass runs: at 1, every micro-step, as the reference does.

On the mesh's data axis (``mesh=``) the replay loader gives each rank its
slice of every replay batch; the losses are the global batch's shares
(``il.losses``) and each batch's gradient is all-reduced BEFORE its clip,
so that the clip sees the global batch's gradient, as under JAX's mesh,
and every rank holds the same replay gradient. On the model axis the loss
runs the student's head trunks split, as the train step runs them
(``models.heads.head_parallel``), and the slices' gradients are joined
over the model group (``parallel.mesh.gather_model_grads``) before that
all-reduce, which then averages over every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..config import FocalConfig, ILConfig
from ..data.loader import put_step_batch
from ..models.heads import head_parallel
from ..parallel.mesh import all_reduce_grads, gather_model_grads
from .losses import LossStatics, compute_losses

Grads = Dict[str, torch.Tensor]


def _is_bn(name: str) -> bool:
    return any(p.startswith("bn") for p in name.split("."))


def bn_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0.0 for frozen-BN leaves (some dot-separated component of the name
    starts with ``bn``; not ``downsample_bn``), 1.0 elsewhere."""
    return {name: (torch.zeros_like if _is_bn(name) else torch.ones_like)(
        p, dtype=torch.float32) for name, p in params.items()}


class AGem:
    """The replay loader and the current averaged replay gradient."""

    def __init__(self, model: torch.nn.Module, anchors: Union[np.ndarray, Callable],
                 il_cfg: ILConfig, focal_cfg: FocalConfig, loss_statics: LossStatics,
                 replay_loader, mesh=None):
        self.model = model
        self.mesh = mesh
        self.replay_loader = replay_loader
        self.replay_grad: Optional[Grads] = None
        self.il_cfg, self.focal_cfg, self.statics = il_cfg, focal_cfg, loss_statics
        self._anchors_provider = anchors if callable(anchors) else (lambda images: anchors)

    def _grad_step(self, model, anchors, images, boxes, labels) -> Grads:
        """The clipped gradient of one replay batch's plain loss."""
        names, params = zip(*model.named_parameters())
        with torch.enable_grad(), head_parallel(model, self.mesh):
            total, _ = compute_losses(model, images, boxes, labels, anchors, self.il_cfg,
                                      self.focal_cfg, self.statics, mesh=self.mesh)
            grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grads = dict(zip(names, grads))
        grads = list(all_reduce_grads(self.mesh, gather_model_grads(self.mesh, grads)).values())
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(0.1 / torch.clamp(norm, min=1e-6), max=1.0)
        return dict(zip(names, torch._foreach_mul(grads, scale)))

    def compute_replay_grad(self, model: Optional[torch.nn.Module] = None) -> Grads:
        """The average clipped gradient over the replay loader with the BN
        leaves zeroed, for ``model`` (default: the one given at
        construction); kept as ``self.replay_grad`` and returned."""
        model = self.model if model is None else model
        device = next(model.parameters()).device
        mask = bn_mask(dict(model.named_parameters()))
        n = max(len(self.replay_loader), 1)
        acc: Optional[Grads] = None
        for batch in self.replay_loader:
            anchors = torch.tensor(self._anchors_provider(batch.images), device=device)
            images, boxes, labels = put_step_batch(device, batch)
            g = self._grad_step(model, anchors, images, boxes, labels)
            g = {k: v * mask[k] / n for k, v in g.items()}
            acc = g if acc is None else {k: acc[k] + v for k, v in g.items()}
        self.replay_grad = acc
        return acc
