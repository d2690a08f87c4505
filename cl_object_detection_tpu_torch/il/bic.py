"""BiC: bias correction of class-incremental logits (the JAX package's
``il/bic.py``).

Each incremental state k >= 1 owns a scalar affine (alpha_k, beta_k) on
its new classes' logits; state-0 classes pass through. The correction is
a per-class (scale, offset) vector, one multiply-add on the logits,
differentiable in (alphas, betas).

Training: after each epoch the detector is frozen (its forward under
``torch.no_grad``, never ``inference_mode``) and only the current
state's (alpha, beta) trains, with optax's Adam at ``BiCConfig.lr``
(``train.optim.Adam``), over a held-out loader, on the plain replay-path
loss (``is_replay=True, is_bic=True``). The held-out set carves
``max(sample_num * ratio, 1)`` images per class out of the replay and the
training streams (``carve_bic_val_set``).

On the mesh's data axis (``mesh=``) the held-out loader gives each rank
its slice of every batch, the loss is the global batch's share
(``il.losses``), and the two scalars' gradient is all-reduced before
their Adam, so every rank takes the same step; the epoch's loss is the
global one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import BiCConfig, FocalConfig, ILConfig
from ..data.loader import put_step_batch
from ..parallel.mesh import all_reduce_grads, all_reduce_metrics
from ..train.optim import Adam
from .losses import LossStatics, compute_losses


class BicParams:
    """alphas and betas per incremental state (``num_states - 1`` float32
    scalars each, on the host)."""

    def __init__(self, num_states: int):
        self.alphas = torch.ones((max(num_states - 1, 1),), dtype=torch.float32)
        self.betas = torch.zeros((max(num_states - 1, 1),), dtype=torch.float32)

    def load(self, tree: Mapping[str, Any]) -> None:
        self.alphas = torch.as_tensor(np.asarray(tree["alphas"], np.float32))
        self.betas = torch.as_tensor(np.asarray(tree["betas"], np.float32))


def class_state_index(new_class_counts: Sequence[int]) -> np.ndarray:
    """The state of each contiguous label: ``[0]*n0 + [1]*n1 + ...``."""
    out: List[int] = []
    for s, n in enumerate(new_class_counts):
        out.extend([s] * n)
    return np.asarray(out, np.int32)


def make_bic_correct(new_class_counts: Sequence[int], num_knowing: int):
    """``fn(logits (B, A, C), alphas, betas) -> corrected logits``: classes
    of state 0 unchanged, those of state k >= 1 ``alpha_{k-1} x +
    beta_{k-1}``."""
    state_of_class = torch.from_numpy(class_state_index(new_class_counts)[:num_knowing]).long()

    def correct(logits, alphas, betas):
        s = state_of_class.to(logits.device)
        idx = torch.clamp(s - 1, min=0)
        scale = torch.where(s == 0, 1.0, alphas.to(logits.device)[idx])
        offset = torch.where(s == 0, 0.0, betas.to(logits.device)[idx])
        return logits * scale[None, None, :] + offset[None, None, :]

    return correct


def bic_correct_from_meta(il_meta, new_class_counts: Sequence[int], num_knowing: int):
    """The inference-time correction from a checkpoint's ``il_meta['bic']``:
    a ``logits -> logits`` callable with per-class ``.scale`` and
    ``.offset`` float32 vectors (what ``Evaluator.predict_dataset_multi``
    takes as runtime vectors). None when the checkpoint carries no BiC
    state."""
    if not il_meta or "bic" not in il_meta:
        return None
    alphas = torch.as_tensor(np.asarray(il_meta["bic"]["alphas"], np.float32))
    betas = torch.as_tensor(np.asarray(il_meta["bic"]["betas"], np.float32))
    correct = make_bic_correct(new_class_counts, num_knowing)

    def fn(logits):
        return correct(logits, alphas, betas)

    s = class_state_index(new_class_counts)[:num_knowing]
    al = np.asarray(il_meta["bic"]["alphas"], np.float32)
    be = np.asarray(il_meta["bic"]["betas"], np.float32)
    idx = np.maximum(s - 1, 0)
    fn.scale = np.where(s == 0, 1.0, al[idx]).astype(np.float32)
    fn.offset = np.where(s == 0, 0.0, be[idx]).astype(np.float32)
    return fn


class _Frozen:
    """The detector's forward under ``torch.no_grad``: the loss's gradient
    flows only through the correction."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def __call__(self, images, enable_act: bool = True):
        with torch.no_grad():
            return self.model(images, enable_act=enable_act)


class BicTrainer:
    """Post-epoch training of the current state's bias scalars over the
    held-out loader."""

    def __init__(self, model: torch.nn.Module, anchors: Union[np.ndarray, Callable],
                 il_cfg: ILConfig, focal_cfg: FocalConfig, bic_cfg: BiCConfig,
                 new_class_counts: Sequence[int], cur_state: int, num_past_class: int,
                 bic_loader, mesh=None):
        self.model = model
        self.mesh = mesh
        self.cur_state = cur_state
        self.bic_loader = bic_loader
        self.params = BicParams(len(new_class_counts))
        num_knowing = sum(new_class_counts[: cur_state + 1])
        self.correct = make_bic_correct(new_class_counts, num_knowing)
        self.il_cfg, self.focal_cfg = il_cfg, focal_cfg
        self.statics = LossStatics(num_classes=num_knowing, num_past_class=num_past_class,
                                   incremental=False, is_replay=True, is_bic=True)
        self._anchors_provider = anchors if callable(anchors) else (lambda images: anchors)
        device = next(model.parameters()).device
        # the trained leaves and their Adam state persist across epochs;
        # train_epoch loads them from (and stores them to) self.params
        self._leaves = [torch.nn.Parameter(t.clone().to(device))
                        for t in (self.params.alphas, self.params.betas)]
        self.opt = Adam([{"name": "bic", "params": self._leaves, "lr": bic_cfg.lr}],
                        lr=bic_cfg.lr)
        # only the current state's slot updates
        self._mask = torch.zeros_like(self._leaves[0])
        self._mask[cur_state - 1] = 1.0

    def correction_fn(self) -> Callable:
        """``logits -> corrected logits`` with the current scalars."""
        alphas, betas = self.params.alphas, self.params.betas
        return lambda logits: self.correct(logits, alphas, betas)

    def _train_step(self, model, anchors, images, boxes, labels) -> Dict[str, torch.Tensor]:
        alphas, betas = self._leaves
        with torch.enable_grad():
            total, metrics = compute_losses(
                _Frozen(model), images, boxes, labels, anchors, self.il_cfg, self.focal_cfg,
                self.statics, bic_correct=lambda logits: self.correct(logits, alphas, betas),
                mesh=self.mesh)
            ga, gb = torch.autograd.grad(total, [alphas, betas])
        g = all_reduce_grads(self.mesh, {"alphas": ga, "betas": gb})
        alphas.grad, betas.grad = g["alphas"] * self._mask, g["betas"] * self._mask
        self.opt.step()
        alphas.grad = betas.grad = None
        return all_reduce_metrics(self.mesh, {k: v.detach() for k, v in metrics.items()})

    def train_epoch(self, model: torch.nn.Module = None) -> float:
        """One pass over the held-out loader with ``model`` frozen (default:
        the one given at construction); returns the mean total loss."""
        model = self.model if model is None else model
        device = self._leaves[0].device
        with torch.no_grad():
            for leaf, value in zip(self._leaves, (self.params.alphas, self.params.betas)):
                leaf.copy_(value)
        total, n = 0.0, 0
        for batch in self.bic_loader:
            anchors = torch.tensor(self._anchors_provider(batch.images), device=device)
            metrics = self._train_step(model, anchors, *put_step_batch(device, batch))
            total += float(metrics["total_loss"])
            n += 1
        self.params.load({"alphas": self._leaves[0].detach().cpu().numpy(),
                          "betas": self._leaves[1].detach().cpu().numpy()})
        return total / max(n, 1)


def carve_bic_val_set(
    train_image_ids: List[int],
    replay_image_ids: List[int],
    replay_seen_class_ids: Sequence[int],
    train_seen_class_ids: Sequence[int],
    new_class_ids: Sequence[int],
    coco,
    sample_num: int,
    ratio: float,
) -> Tuple[List[int], List[List[int]], List[int], List[int]]:
    """Carve ``per_num = max(int(sample_num * ratio), 1)`` images per class
    out of both streams: from each class block of the replay list, then
    per new class from the training list (the lowest ids holding it).

    Returns (bic_image_ids, per_image_seen_class_lists,
    remaining_train_ids, remaining_replay_ids)."""
    per_num = max(int(sample_num * ratio), 1)
    bic_ids: List[int] = []
    seen_lists: List[List[int]] = []
    train_ids = list(train_image_ids)
    replay_ids = list(replay_image_ids)
    step = max(sample_num, 1)
    for start in range(0, len(replay_ids) // step * sample_num, step):
        for img_id in replay_image_ids[start: start + sample_num][:per_num]:
            bic_ids.append(img_id)
            seen_lists.append(list(replay_seen_class_ids))
            replay_ids.remove(img_id)
    remaining_new = list(train_ids)
    for cat_id in new_class_ids:
        cand = sorted(set(coco.get_imgs_by_cats(cat_id)) & set(remaining_new))
        for img_id in cand[:per_num]:
            bic_ids.append(img_id)
            seen_lists.append(list(train_seen_class_ids))
            train_ids.remove(img_id)
            remaining_new.remove(img_id)
    return bic_ids, seen_lists, train_ids, replay_ids
