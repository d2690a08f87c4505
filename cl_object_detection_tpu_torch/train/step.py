"""The train step (the JAX package's ``train/step.py``).

One micro-step: forward + ``compute_losses`` + backward into the
accumulator (the parameters' ``.grad``); on every ``every_iter``-th
micro-step the sum is divided by ``every_iter``, then, in JAX's order:
trainable mask -> clip by global norm -> zero the warm old classes ->
A-GEM projection -> Adam, and the accumulator is cleared. Everything
runs on the model's device; the micro-step counts live on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..config import FocalConfig, ILConfig
from ..il.losses import INCREMENTAL_NOT_PORTED, LossStatics, compute_losses
from .state import TrainState

Grads = Dict[str, torch.Tensor]
_CLS_OUT_W = "classification_head.output.weight"
_CLS_OUT_B = "classification_head.output.bias"


@dataclass(frozen=True)
class StepStatics:
    """Static switches of the step."""
    every_iter: int = 2
    use_clip: bool = True              # ¬no_clip ∧ ¬warm-classifier
    grad_clip: float = 0.1
    warm_classifier: bool = False      # zero old-class output grads
    num_past_class: int = 0
    num_knowing_class: int = 0
    num_anchors: int = 9
    use_agem: bool = False


def _zero_old_class_grads(grads: Grads, s: StepStatics) -> Grads:
    """During the classifier warm stage the old-class rows of the
    classification output conv get zero gradient, per anchor slot (the
    output channel is anchor * C + class)."""
    w, b = grads[_CLS_OUT_W], grads[_CLS_OUT_B]
    c = s.num_knowing_class
    keep = (torch.arange(c, device=w.device) >= s.num_past_class).to(w.dtype)
    out = dict(grads)
    out[_CLS_OUT_W] = (w.reshape(s.num_anchors, c, -1) * keep[:, None]).reshape(w.shape)
    out[_CLS_OUT_B] = (b.reshape(s.num_anchors, c) * keep).reshape(b.shape)
    return out


def _clip_by_global_norm(grads: Grads, max_norm: float) -> Grads:
    """Scale by ``min(1, max_norm / max(||g||, 1e-6))``: JAX's formula,
    not ``clip_grad_norm_``'s ``max_norm / (||g|| + 1e-6)``."""
    # sums of squares, not torch.linalg.vector_norm: its CPU reduction is
    # off by ~4e-5 relative on a 2.4M-element leaf, torch.sum's by ~1e-8
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return dict(zip(grads, torch._foreach_mul(list(grads.values()), scale)))


def _agem_project(grads: Grads, replay_grad: Grads) -> Grads:
    """A-GEM: if <g, g_r> < 0, g <- g - (<g, g_r> / ||g_r||^2) g_r."""
    dot = sum(torch.sum(g * replay_grad[k]) for k, g in grads.items())
    rr = sum(torch.sum(r * r) for r in replay_grad.values())
    coef = torch.where(dot < 0, dot / torch.clamp(rr, min=1e-12), 0.0)
    return {k: g - coef * replay_grad[k] for k, g in grads.items()}


def make_train_step(
    model: torch.nn.Module,
    teacher_model,
    anchors,
    il_cfg: ILConfig,
    focal_cfg: FocalConfig,
    loss_statics: LossStatics,
    step_statics: StepStatics,
):
    """Build the step for ``model`` (the model of the states it is given).

    Returns ``fn(state, images, boxes, labels, *, replay_grad=None,
    trainable_mask=None) -> (state, metrics)``: ``state`` is updated in
    place and returned; ``metrics`` holds the detached loss terms under
    the JAX keys. ``replay_grad`` maps parameter names to the A-GEM
    replay gradient; ``trainable_mask`` is ``train.trainer.
    trainable_mask``'s. A teacher (the incremental states) raises
    ``NotImplementedError``.

    With ``every_iter <= 1`` and ``enhance_only`` (the final correction),
    a batch whose loss is not > 0 skips the optimizer, moments included,
    as JAX does. The port decides that on the host: it reads the loss,
    one host sync per micro-step in that phase only.
    """
    if teacher_model is not None:
        raise NotImplementedError(INCREMENTAL_NOT_PORTED)
    ss = step_statics
    device = next(model.parameters()).device
    anchors = torch.tensor(anchors, dtype=torch.float32, device=device)
    params = dict(model.named_parameters())

    def apply(state: TrainState, g: Grads, trainable_mask, replay_grad) -> None:
        if trainable_mask is not None:
            g = {k: v * trainable_mask[k] for k, v in g.items()}
        if ss.use_clip and ss.grad_clip > 0:
            g = _clip_by_global_norm(g, ss.grad_clip)
        if ss.warm_classifier:
            g = _zero_old_class_grads(g, ss)
        if ss.use_agem and replay_grad is not None:
            g = _agem_project(g, replay_grad)
        for k, p in params.items():
            p.grad = g[k]
        state.optimizer.step()

    def step_fn(state: TrainState, images, boxes, labels, *,
                replay_grad: Optional[Grads] = None,
                trainable_mask: Optional[Dict[str, float]] = None):
        with torch.enable_grad():
            total, metrics = compute_losses(
                state.model, images, boxes, labels, anchors, il_cfg, focal_cfg,
                loss_statics)
            total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        state.step += 1
        if ss.every_iter <= 1:
            if not loss_statics.enhance_only or bool(total > 0):
                apply(state, state.grad_acc, trainable_mask, replay_grad)
        else:
            state.acc_count += 1
            if state.acc_count < ss.every_iter:
                return state, metrics
            g = state.grad_acc
            apply(state, dict(zip(g, torch._foreach_div(list(g.values()), ss.every_iter))),
                  trainable_mask, replay_grad)
            state.acc_count = 0
        state.model.zero_grad(set_to_none=True)
        return state, metrics

    return step_fn
