"""The train step (the JAX package's ``train/step.py``).

One micro-step: forward + ``compute_losses`` + backward into the
accumulator (the parameters' ``.grad``); on every ``every_iter``-th
micro-step the sum is divided by ``every_iter``, then, in JAX's order:
trainable mask -> clip by global norm -> zero the warm old classes ->
A-GEM projection -> Adam, and the accumulator is cleared. Everything
runs on the model's device; the micro-step counts live on the host.

At states >= 1 the frozen teacher (the previous state's model, in eval
mode, ``requires_grad_(False)``) runs its forward inside
``compute_losses`` under ``torch.no_grad``, never ``inference_mode``:
tensors cached under inference mode would break the student's next
backward.

On the mesh's data axis (``mesh=``) each rank's loss is its share of the
global batch's (``il.losses``), the accumulated gradient is all-reduced
once per apply (``parallel.mesh.all_reduce_grads``) before the mask, the
clip, the warm zeroing and the A-GEM projection, which then see the global
gradient, so every rank's Adam takes the same step; the metrics are the
global batch's loss terms, and the final correction's skip is decided on
the global loss, so the ranks never part. Under ZeRO-1 the optimizer
(``train/optim.py``) then updates this rank's slices and all-gathers the
parameters, so the order is: all-reduce -> mask -> clip -> warm zeroing ->
A-GEM -> Adam on the shard -> all-gather. Every step before Adam sees the
whole all-reduced gradient, which keeps ZeRO-1 bit for bit the data
axis's run (a reduce-scatter in place of the all-reduce would change the
clip's summation order).

On the model axis (``mesh.num_model > 1``) the student's forward runs its
head trunks split over the model group (``models.heads.head_parallel``):
a trunk leaf's ``.grad`` on this rank is right only in its slice, so each
apply first joins the slices' gradients over the model group
(``parallel.mesh.gather_model_grads``) into the whole gradient, then runs
the data axis's steps above on it. The ranks of a model group read the
same slice of the batch, so they hold the same whole gradient up to the
card's nondeterministic reductions (a replicated leaf's gradient is
computed on each); the all-reduce averages over every rank, which leaves
them the same bits, and Adam updates each rank's block of every leaf
(``train/optim.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..config import FocalConfig, ILConfig
from ..il.losses import LossStatics, compute_losses
from ..models.heads import head_parallel
from ..parallel.mesh import DataMesh, all_reduce_grads, all_reduce_metrics, gather_model_grads
from ..utils.profiling import span
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
    mesh: Optional[DataMesh] = None,
):
    """Build the step for ``model`` (the model of the states it is given).

    Returns ``fn(state, images, boxes, labels, *, replay_grad=None,
    trainable_mask=None, classifier_vectors=None, pseudo_progress=None,
    prototype_features=None, mas_prev_params=None, mas_importance=None)
    -> (state, metrics)``: ``state`` is updated
    in place and returned; ``metrics`` holds the detached loss terms
    under the JAX keys. ``replay_grad`` maps parameter names to the
    A-GEM replay gradient; ``trainable_mask`` is
    ``train.trainer.trainable_mask``'s; ``classifier_vectors`` is the
    teacher's ``(C_old, D)`` tensor of the classifier-similarity loss;
    ``pseudo_progress`` the pseudo-label discount's training progress
    (a 0-d float32 tensor); ``prototype_features`` the stored old-class
    prototypes averaged over the anchor slots, ``(C_old, D)``;
    ``mas_prev_params`` and ``mas_importance`` map parameter names to the
    previous state's parameters and their MAS importance
    (``il.mas.compute_importance``). ``teacher_model`` (None at state 0)
    is set to eval mode and frozen.

    With ``every_iter <= 1`` and ``enhance_only`` (the final correction),
    a batch whose loss is not > 0 skips the optimizer, moments included,
    as JAX does. The port decides that on the host: it reads the loss,
    one host sync per micro-step in that phase only. ``mesh``: the data
    and model axes (module docstring).
    """
    if teacher_model is not None:
        teacher_model.eval().requires_grad_(False)
    ss = step_statics
    device = next(model.parameters()).device
    anchors = torch.tensor(anchors, dtype=torch.float32, device=device)
    params = dict(model.named_parameters())

    def apply(state: TrainState, trainable_mask, replay_grad) -> None:
        """The accumulated gradient (its mean over ``every_iter``) through
        the optimizer: the span ``cldet.train.apply``."""
        with span("cldet.train.apply"):
            g = state.grad_acc
            if ss.every_iter > 1:
                g = dict(zip(g, torch._foreach_div(list(g.values()), ss.every_iter)))
            g = all_reduce_grads(mesh, gather_model_grads(mesh, g))
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
                trainable_mask: Optional[Dict[str, float]] = None,
                classifier_vectors: Optional[torch.Tensor] = None,
                pseudo_progress: Optional[torch.Tensor] = None,
                prototype_features: Optional[torch.Tensor] = None,
                mas_prev_params: Optional[Grads] = None,
                mas_importance: Optional[Grads] = None):
        with torch.enable_grad(), head_parallel(state.model, mesh):
            with span("cldet.train.forward"):
                total, metrics = compute_losses(
                    state.model, images, boxes, labels, anchors, il_cfg, focal_cfg,
                    loss_statics, teacher=teacher_model,
                    classifier_vectors=classifier_vectors, pseudo_progress=pseudo_progress,
                    prototype_features=prototype_features, mas_prev_params=mas_prev_params,
                    mas_importance=mas_importance, mesh=mesh)
            with span("cldet.train.backward"):
                total.backward()
        metrics = all_reduce_metrics(mesh, {k: v.detach() for k, v in metrics.items()})
        state.step += 1
        if ss.every_iter <= 1:
            if not loss_statics.enhance_only or bool(metrics["total_loss"] > 0):
                apply(state, trainable_mask, replay_grad)
        else:
            state.acc_count += 1
            if state.acc_count < ss.every_iter:
                return state, metrics
            apply(state, trainable_mask, replay_grad)
            state.acc_count = 0
        state.model.zero_grad(set_to_none=True)
        return state, metrics

    return step_fn
