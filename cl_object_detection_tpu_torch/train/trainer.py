"""The IL trainer (the JAX package's ``train/trainer.py``).

``ILTrainer`` owns the datasets, the model and its optimizer on the
device ``resolve_device`` gives, the train-step variants, the warm-up
stages, the LR schedule, the checkpoints and the resume:

  * a train step per (batch kind, warm stage, state, canonical frame,
    prototype phase), built by ``train.step.make_train_step``;
  * warm-up staged freezing as gradient masks (``trainable_mask``);
  * each ``Batch`` goes to the device once per micro-step through pinned
    memory, with a non-blocking copy;
  * checkpoints through ``utils/checkpoint.CheckpointManager``; a
    mid-state resume restores the parameters, the frozen-BN buffers, the
    Adam moments, counts, LR and betas of both groups, the micro-step
    count and the running-loss window;
  * ``--pretrained`` (torchvision backbone) and ``--torch_ckpt`` (a
    reference-trained RetinaNet, plus its Adam state on a mid-state
    resume) seed the model through ``models/convert.py``;
  * states >= 1: ``next_state`` (and the cross-state entry, a
    ``start_state`` >= 1 at epoch 1 from the previous state's checkpoint
    or ``--torch_ckpt``) computes or reads back the similarity sidecar,
    expands the classifier (``models/expand.py``), standardizes it under
    ``--scail`` and starts a fresh optimizer; the frozen teacher is the
    previous state's newest checkpoint, with its class vectors under
    ``--classifier_loss``;
  * the tools of a state >= 1, in JAX's order: the prototypes of the
    previous state (``il/prototype.py``, cached as the
    ``prototype_features`` array sidecar), the replay set (``--sample_num``
    exemplars per old class by herding, prototype-herd or at random,
    recorded as the ``examplar`` sidecar and ``examplar.txt``), the
    expansion, BiC (its held-out set carved out of the replay and the
    training streams, ``il/bic.py``; the learned scalars of earlier
    states carry over), the replay loader, A-GEM (``il/agem.py``), the
    teacher (built for MAS even with distillation off), MAS
    (``il/mas.py``: the importance, cached as the ``mas_importance`` array
    sidecar of the previous state under the port's parameter names, and
    the previous parameters), and the teacher's pseudo-labels on the new
    images (``il/pseudo_label.py``; the teacher is built for them even
    with distillation off). ``next_state`` computes the importance with
    the finished state's model on its data before it moves on; the
    cross-state entry, finding no sidecar, computes it with the expanded
    model on the new state's data, as JAX does.

The mesh (``MeshConfig.enabled``, ``parallel/mesh.py``): the trainer is
one rank of the process group (one rank when there is none) on its
device, at a place on the ``num_data x num_model`` grid. The train, replay
and BiC loaders give each rank its data index's slice of every global
batch (JAX's ``_proc_shard``; the ranks of a model group read the same
slice), the batch sizes must divide by ``num_data`` and ``fpn_channels``
by ``num_model``, the step splits the student's head trunks over the
model group and joins their gradients, then all-reduces the gradient over
the data group once per apply, rank 0's parameters are broadcast after
construction and after each expansion, the IL tool passes split their
loaders' whole batches over all the ranks, on whole weights, and gather
the results back into one process's order (``parallel.mesh``), only rank
0 writes checkpoints and sidecars, and the loop's
``parallel.mesh.check_replicas`` after every epoch raises if any rank's
(whole) parameters part from rank 0's. Every optimizer the trainer builds
keeps this rank's blocks of the Adam moments (the model axis's slices of
the head trunks; under ``--zero1``, ``MeshConfig.zero1``, also the data
axis's) (``train/optim.py``); the ``mesh:`` line, printed with each new
optimizer, names both axes and gives the moment bytes on this rank. A
resume, a ``--torch_ckpt`` optimizer and a checkpoint all hold whole
moments, of which each rank keeps its blocks.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig
from ..data.coco import CocoJson
from ..data.dataset import BicDataset, ILDataset, ReplayDataset
from ..data.loader import BatchLoader, put_step_batch
from ..data.transforms import logical_image_hw
from ..il.agem import AGem
from ..il.bic import BicTrainer, carve_bic_val_set
from ..il.herding import HerdSampler
from ..il.losses import LossStatics
from ..il.mas import compute_importance
from ..il.prototype import (compute_prototype_features, prototype_herd_scores,
                            prototype_herd_slot_scores, sample_by_scores,
                            sample_by_slot_scores)
from ..il.pseudo_label import generate_pseudo_labels
from ..il.scail import standardize_new_classifier
from ..il.weight_init import compute_similarity
from ..models.expand import classifier_class_vectors, expand_classifier
from ..models.retinanet import create_retinanet
from ..ops.anchors import anchors_for_shape
from ..parallel import mesh as pmesh
from ..states import ILStates
from ..utils.checkpoint import CheckpointManager
from ..utils.profiling import span
from .optim import lr_at_epoch, make_optimizer, set_beta1, set_learning_rate
from .state import TrainState
from .step import StepStatics, make_train_step

WARM_WHITE_LIST = {
    # which parameter-name prefixes TRAIN in each warm stage
    "output": ("classification_head.output.",),
    "fpn": ("classification_head.", "regression_head."),
    "resnet": ("fpn.", "classification_head.", "regression_head."),
}


def trainable_mask(model: torch.nn.Module,
                   warm_kind: Optional[str]) -> Optional[Dict[str, float]]:
    """1.0 for each trainable parameter and 0.0 for each frozen one, by
    name; None (no mask) outside warm stages. The step multiplies each
    gradient by its entry, as JAX multiplies by a tree of ones and
    zeros."""
    if warm_kind is None:
        return None
    allow = WARM_WHITE_LIST[warm_kind]
    return {name: 1.0 if name.startswith(allow) else 0.0
            for name, _ in model.named_parameters()}


class ILTrainer:
    def __init__(self, cfg: TrainConfig, train_json: str, image_dir: str,
                 workdir: str = ".", device=None):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        self.mesh: Optional[pmesh.DataMesh] = None
        if cfg.mesh.enabled:
            self.mesh = pmesh.create_mesh(cfg.mesh, self.device)
            ndata = self.mesh.num_data
            if cfg.model.fpn_channels % self.mesh.num_model:
                raise ValueError(
                    f"fpn_channels {cfg.model.fpn_channels} not divisible by the model-axis "
                    f"size {self.mesh.num_model}: the head trunks split their channels")
            if cfg.data.batch_size % ndata:
                raise ValueError(f"batch_size {cfg.data.batch_size} not divisible by the "
                                 f"data-axis size {ndata}")
            if cfg.il.replay.sample_num > 0 and cfg.il.replay.sample_batch_size % ndata:
                raise ValueError(
                    f"replay sample_batch_size {cfg.il.replay.sample_batch_size} not "
                    f"divisible by the data-axis size {ndata} (set --sample_batch_size)")
        self.primary = pmesh.is_primary(self.mesh)
        self.coco = CocoJson(train_json)
        self.image_dir = image_dir
        self.states = ILStates(
            list(self.coco.classes.values()),
            self.coco.classes_inverse,
            list(cfg.il.scenario),
            shuffle_class=cfg.il.shuffle_class,
            shuffle_seed=cfg.il.shuffle_seed,
        )
        self.cur_state = cfg.il.start_state
        self.cur_epoch = 0
        self.end_epoch = 0
        self.cur_warm_stage = -1
        self._warm_kind: Optional[str] = None
        self._trainable = None
        self._steps: Dict[Any, Any] = {}
        self._beta_is_replay: Optional[bool] = None
        # the 500-deep running-loss window of full per-batch losses,
        # persisted in the checkpoint and restored on a mid-state resume
        self.loss_hist: collections.deque = collections.deque(maxlen=500)
        # per-epoch timing records of train_process (train/loop.py)
        self.epoch_log: List[Dict[str, float]] = []
        self.save_blocking_s: Optional[float] = None

        self.ckpt = CheckpointManager(
            os.path.join(workdir, cfg.checkpoint_dir), cfg.il.scenario,
            cfg.keep_every, mesh=self.mesh,
        )

        # datasets ------------------------------------------------------
        self.dataset_train = ILDataset(
            self.coco, self.states, image_dir, split="train",
            start_state=self.cur_state, use_data_ratio=cfg.data.use_data_ratio,
        )
        self.dataset_replay: Optional[ReplayDataset] = None
        self.replay_loader: Optional[BatchLoader] = None

        # model ---------------------------------------------------------
        h, w = cfg.data.height, cfg.data.width
        self._anchors_cache: Dict[Any, np.ndarray] = {}
        self._anchors_at(h, w)
        self._anchors_at(w, h)

        # cross-state entry: state k at epoch 1 starts from state k-1's
        # newest checkpoint (or --torch_ckpt) at the previous class
        # count, then expands
        start_epoch = cfg.start_epoch or 1
        ref_ckpt = cfg.torch_ckpt
        cross_state = (self.cur_state >= 1 and start_epoch == 1 and (
            ref_ckpt is not None or self.ckpt.latest_epoch(self.cur_state - 1) is not None))
        self.num_classes = self.states[
            self.cur_state - 1 if cross_state else self.cur_state].num_knowing_class
        self.model = create_retinanet(
            cfg.model, self.num_classes, device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed))
        if ref_ckpt:
            # previous-state weights on a state entry, this state's
            # otherwise (its optimizer after _new_train_state below)
            from ..models.convert import load_reference_checkpoint

            load_reference_checkpoint(self.model, ref_ckpt,
                                      allow_pickle=cfg.trust_torch_ckpt)
        elif cross_state:
            self.model.load_state_dict(self.ckpt.restore(self.cur_state - 1, -1)[0]["model"])
        elif (start_epoch > 1
              and self.ckpt.nearest_epoch(self.cur_state, start_epoch - 1) is not None):
            # mid-state resume: the weights now, before the teacher and
            # the tools, the optimizer in resume() (cli.train); with
            # --save_every k>1 the newest saved epoch <= start_epoch-1
            # stands in for a missing one
            resume_epoch = self.ckpt.nearest_epoch(self.cur_state, start_epoch - 1)
            tree, _ = self.ckpt.restore(self.cur_state, resume_epoch)
            self.model.load_state_dict(tree["model"])
        elif cfg.model.pretrained:
            from ..models.convert import load_pretrained_backbone

            load_pretrained_backbone(self.model, cfg.model.pretrained)
        pmesh.broadcast_module(self.mesh, self.model)
        self._new_train_state()
        if ref_ckpt and start_epoch > 1:
            # a mid-state resume continues the reference run's optimizer
            from ..models.convert import load_reference_optimizer

            try:
                load_reference_optimizer(self.model, self.optimizer, ref_ckpt,
                                         allow_pickle=cfg.trust_torch_ckpt)
            except ValueError as e:
                print(f"warning: optimizer state not imported ({e}); "
                      "continuing with fresh Adam moments")

        # CL tools, in JAX's order. The prototypes and the exemplars come
        # from the previous state's model, before the expansion.
        self.teacher_model = None
        self._teacher_class_vectors: Optional[torch.Tensor] = None
        self.mas_importance: Optional[Dict[str, torch.Tensor]] = None
        self.mas_prev_params: Optional[Dict[str, torch.Tensor]] = None
        self.agem: Optional[AGem] = None
        self.bic: Optional[BicTrainer] = None
        self.herd_sampler: Optional[HerdSampler] = None
        self.prototype_features: Optional[np.ndarray] = None
        self._prototype_mean: Optional[torch.Tensor] = None
        self._proto_exemplars: List[int] = []
        self._progress: Dict[Any, torch.Tensor] = {}
        if self.cur_state >= 1:
            self._init_prototyper()
            self._init_replay_dataset()
            if cross_state:
                self._expand_training_tools()
            self._init_bic()
            self._update_replay_loader()
            self._init_agem()
            self._update_prev_model()
            self._update_mas()
            self._add_pseudo_labels()
        self.train_loader = self._make_train_loader()

    # ------------------------------------------------------------------
    # infrastructure
    # ------------------------------------------------------------------
    def _new_train_state(self) -> None:
        """A fresh optimizer (both Adam groups at the schedule's LR; on the
        mesh its shard plans over the current model's leaves) and train
        state over the current model; on the mesh, the ``mesh:`` line."""
        self.optimizer = make_optimizer(self.cfg.schedule, self.model, self.mesh)
        if self.mesh is not None:
            print(pmesh.describe(self.mesh, self.optimizer.moment_bytes()))
        self.train_state = TrainState(self.model, self.optimizer)
        self._beta_is_replay = None
        self._steps.clear()

    def _put_batch(self, batch):
        """(images, boxes, labels) of this rank's batch on the trainer's
        device: pinned host copies, then non-blocking copies to the card."""
        return put_step_batch(self.device, batch)

    def _make_train_loader(self, sharded: bool = True) -> BatchLoader:
        """The training loader; ``sharded``: this rank's slice of each
        global batch, as every loader that feeds a step (train, replay,
        BiC) gives it; the tool passes read whole batches on every rank."""
        return BatchLoader(self.dataset_train, self.cfg.data, shuffle=True,
                           augment=True, seed=self.cfg.seed,
                           **(pmesh.proc_shard(self.mesh) if sharded else {}))

    def _anchors_at(self, h: int, w: int) -> np.ndarray:
        key = (h, w)
        if key not in self._anchors_cache:
            self._anchors_cache[key] = anchors_for_shape(h, w)
        return self._anchors_cache[key]

    def anchors_for(self, images) -> np.ndarray:
        return self._anchors_at(*logical_image_hw(images))

    def variables(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and frozen-BN buffers by name."""
        return self.model.state_dict()

    # ------------------------------------------------------------------
    # state transition
    # ------------------------------------------------------------------
    def next_state(self) -> None:
        """Into the next state: the MAS importance of the finished state
        (its model, its data), the dataset moves to the new classes, the
        finished state's prototypes, the classifier expands (similarity
        warm-start, SCAIL) with a fresh optimizer, the replay set, BiC, the
        replay loader and A-GEM are rebuilt (BiC's learned scalars carry
        over), the teacher becomes the finished state's newest checkpoint
        (and MAS's previous parameters), and it pseudo-labels the new
        images."""
        cfg = self.cfg.il
        if cfg.mas.enabled:
            self._update_mas_for_next()
        self.cur_state += 1
        self.dataset_train.next_state()
        self._init_prototyper()
        self._expand_training_tools()
        if self.dataset_replay is not None or cfg.replay.sample_num > 0:
            self._init_replay_dataset()
            self._init_bic()
            self._update_replay_loader()
            self._init_agem()
        self.train_loader = self._make_train_loader()
        self._update_prev_model()
        self._add_pseudo_labels()

    def _expand_training_tools(self) -> None:
        """Similarity warm-start, classifier expansion, SCAIL and a fresh
        optimizer. ``self.model`` is still the previous state's model
        (the similarity pass runs it); ``self.dataset_train`` is already
        the new state's. The similarity is cached as the ``similarity``
        array sidecar of the previous state and read back when present."""
        cfg = self.cfg.il
        st = self.states[self.cur_state]
        num_anchors = self.cfg.model.num_anchors
        similarity = None
        if cfg.init_method in ("mean", "large", "onlyNegative") and st.num_past_class > 0:
            cached = self._agreed_sidecar(self.cur_state - 1, "similarity")
            if cached is not None:
                similarity = np.asarray(list(cached.values())[0])
            else:
                # unaugmented, unshuffled images, as JAX
                loader = BatchLoader(self.dataset_train, self.cfg.data, shuffle=False,
                                     augment=False)
                similarity = compute_similarity(self.model, self.anchors_for, loader,
                                                num_new=st.num_new_class,
                                                num_old=st.num_past_class, mesh=self.mesh)
                # the key JAX's sidecar of a one-element list has
                self.ckpt.save_array_sidecar(self.cur_state - 1, "similarity",
                                             {"[0]": similarity})
        new_state = expand_classifier(self.model.state_dict(), st.num_new_class,
                                      num_anchors=num_anchors, prior=self.cfg.model.prior,
                                      similarity=similarity, method=cfg.init_method)
        if cfg.scail and st.num_past_class > 0:
            new_state = standardize_new_classifier(new_state, st.num_past_class, num_anchors)
            print(f"scail: standardized {st.num_new_class} new-class filters to the old "
                  "ranked-mean profile")
        self.num_classes = st.num_knowing_class
        self.model = create_retinanet(
            self.cfg.model, self.num_classes, device=self.device,
            generator=torch.Generator().manual_seed(self.cfg.seed))
        self.model.load_state_dict(new_state)
        pmesh.broadcast_module(self.mesh, self.model)
        self._new_train_state()

    def _agreed_sidecar(self, state: int, name: str) -> Optional[Dict[str, np.ndarray]]:
        """An array sidecar when rank 0 finds one: every rank follows rank
        0's finding, so that all compute the pass or none does."""
        cached = self.ckpt.load_array_sidecar(state, name)
        found = pmesh.broadcast_object(self.mesh, cached is not None)
        if found and cached is None:
            raise FileNotFoundError(f"rank {self.mesh.rank} cannot read the {name} sidecar "
                                    f"of state {state} that rank 0 read")
        return cached if found else None

    def _update_prev_model(self, force: bool = False) -> None:
        """The frozen teacher of distillation and MAS (and, with ``force``,
        of the pseudo-labels): the previous state's model from its newest
        checkpoint, on the trainer's device; its parameters are MAS's
        previous ones, and its class vectors are taken when
        ``classifier_loss`` is set."""
        cfg = self.cfg.il
        if not force and not cfg.distill.enabled and not cfg.mas.enabled:
            return
        prev = self.cur_state - 1
        teacher = create_retinanet(
            self.cfg.model, self.states[prev].num_knowing_class, device=self.device,
            generator=torch.Generator().manual_seed(self.cfg.seed))
        tree, _ = self.ckpt.restore(prev, -1)
        teacher.load_state_dict(tree["model"])
        self.teacher_model = teacher.requires_grad_(False)
        self.mas_prev_params = dict(teacher.named_parameters())
        if cfg.classifier_loss:
            self._teacher_class_vectors = torch.from_numpy(classifier_class_vectors(
                tree["model"], self.cfg.model.num_anchors)).to(self.device)
        self._steps.clear()

    # ------------------------------------------------------------------
    # replay, prototypes, pseudo-labels
    # ------------------------------------------------------------------
    def _prev_state_dataset(self, state: int) -> ILDataset:
        return ILDataset(self.coco, self.states, self.image_dir, split="train",
                         start_state=state)

    def _future_img_ids(self) -> List[int]:
        future: List[int] = []
        for i in range(self.cur_state, len(self.states)):
            future.extend(self.states[i].new_ids)
        return self.coco.get_imgs_by_cats(future)

    def _init_prototyper(self) -> None:
        """The previous state's ``(C, 9, D)`` prototypes, read back from
        its ``prototype_features`` array sidecar or computed over its
        unaugmented training images (with the model as it stands) and
        written there under JAX's key."""
        cfg = self.cfg.il
        if not (cfg.prototype.loss or cfg.replay.sample_method == "prototype_herd"):
            return
        prev = self.cur_state - 1
        cached = self._agreed_sidecar(prev, "prototype_features")
        if cached is not None:
            self.prototype_features = np.asarray(list(cached.values())[0])
        else:
            loader = BatchLoader(self._prev_state_dataset(prev), self.cfg.data,
                                 shuffle=False, augment=False)
            self.prototype_features = compute_prototype_features(
                self.model, self.anchors_for, loader, self.states[prev].num_knowing_class,
                mesh=self.mesh)
            self.ckpt.save_array_sidecar(prev, "prototype_features",
                                         {"[0]": self.prototype_features})
        # slot-averaged, as the loss reads them at every step
        self._prototype_mean = torch.from_numpy(
            self.prototype_features.mean(axis=1)).to(self.device)

    def _init_replay_dataset(self) -> None:
        """The replay set of ``sample_num`` exemplars per old class:
        herding and prototype-herd picks accumulate across states, a
        random draw is taken anew (seeded by ``cfg.seed``). Recorded as the
        ``examplar`` sidecar and ``examplar.txt`` (+ ``examplar.png``)."""
        cfg = self.cfg.il.replay
        if cfg.sample_num <= 0:
            return
        self.dataset_replay = ReplayDataset(self.coco, self.states, self.image_dir,
                                            per_num=cfg.sample_num, seed=self.cfg.seed)
        prev = self.cur_state - 1
        if cfg.sample_method == "herd":
            if self.herd_sampler is None:
                self.herd_sampler = HerdSampler(cfg.herd_ratio_threshold)
            self.herd_sampler.sample(self.model, self._prev_state_dataset(prev), self.cfg.data,
                                     cfg.sample_num, future_img_ids=self._future_img_ids(),
                                     mesh=self.mesh)
            self.dataset_replay.reset_explicit(cfg.sample_num, self.herd_sampler.examplar_list,
                                               self.cur_state)
        elif cfg.sample_method == "prototype_herd":
            if self.prototype_features is None:
                raise ValueError("prototype_herd sampling needs the prototypes")
            prev_ds = self._prev_state_dataset(prev)
            future = set(self._future_img_ids())
            # the newest scores cover only the previous state's new
            # classes, so earlier states' picks persist
            if cfg.prototype_herd_mode == "slots":
                slot_scores, counts = prototype_herd_slot_scores(
                    self.model, self.anchors_for, prev_ds, self.cfg.data,
                    self.prototype_features, mesh=self.mesh)
                st = self.states[prev]
                picked = sample_by_slot_scores(
                    slot_scores, counts, cfg.sample_num,
                    classes=range(st.num_past_class, st.num_knowing_class),
                    already=self._proto_exemplars, exclude=future,
                    num_anchors=self.prototype_features.shape[1])
            else:
                scores = prototype_herd_scores(self.model, self.anchors_for, prev_ds,
                                               self.cfg.data, self.prototype_features,
                                               mesh=self.mesh)
                scores = {c: {i: v for i, v in d.items() if i not in future}
                          for c, d in scores.items()}
                picked = sample_by_scores(scores, cfg.sample_num,
                                          already=self._proto_exemplars)
            self._proto_exemplars.extend(i for ids in picked.values() for i in ids)
            self.dataset_replay.reset_explicit(cfg.sample_num, list(self._proto_exemplars),
                                               self.cur_state)
        else:  # random
            self.dataset_replay.reset_by_state(self.cur_state)
        if pmesh.broadcast_object(self.mesh, list(self.dataset_replay.image_ids)) != list(
                self.dataset_replay.image_ids):
            raise RuntimeError("the ranks picked different exemplars")
        self.ckpt.save_sidecar(self.cur_state, "examplar", list(self.dataset_replay.image_ids))
        self._write_examplar_outputs()

    def _write_examplar_outputs(self) -> None:
        """``examplar.txt`` (one image id per line) and, with
        ``output_examplar`` and OpenCV present, the ``examplar.png``
        montage: ``sample_num`` thumbnails per old class, the class name
        captioned."""
        if not self.primary:
            return
        state_dir = self.ckpt.state_dir(self.cur_state)
        img_ids = list(self.dataset_replay.image_ids)
        with open(os.path.join(state_dir, "examplar.txt"), "w") as f:
            for img_id in img_ids:
                f.write(f"{img_id}\n")
        if not self.cfg.output_examplar or not img_ids:
            return
        try:
            import cv2
        except ImportError:
            return
        per = self.cfg.il.replay.sample_num
        num_classes = max(len(img_ids) // per, 1)
        names = self.states[len(self.states) - 1].knowing_names[:num_classes]
        th, tw = 180, 240  # thumbnail cell
        rows = []
        for r in range(num_classes):
            cells = []
            for c in range(per):
                k = r * per + c
                cell = np.zeros((th, tw, 3), np.uint8)
                if k < len(img_ids):
                    info = self.coco.imgs[img_ids[k]]
                    im = cv2.imread(os.path.join(self.image_dir, info["file_name"]))
                    if im is not None:
                        cell = cv2.resize(im, (tw, th))
                    cv2.putText(cell, names[r] if r < len(names) else "?", (4, 16),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1, cv2.LINE_AA)
                cells.append(cell)
            rows.append(np.concatenate(cells, axis=1))
        cv2.imwrite(os.path.join(state_dir, "examplar.png"), np.concatenate(rows, axis=0))

    def _update_replay_loader(self) -> None:
        if self.dataset_replay is None:
            return
        self.replay_loader = BatchLoader(
            self.dataset_replay, self.cfg.data,
            batch_size=self.cfg.il.replay.sample_batch_size,
            shuffle=True, augment=True, seed=self.cfg.seed, is_replay=True,
            **pmesh.proc_shard(self.mesh))

    # ------------------------------------------------------------------
    # BiC, A-GEM, MAS
    # ------------------------------------------------------------------
    def _init_bic(self) -> None:
        """BiC for the current state: its held-out set carved out of the
        training and the replay streams, its loader, and its trainer; the
        scalars of the state before carry over (only the current slot
        trains)."""
        cfg = self.cfg.il
        if not cfg.bic.enabled:
            return
        if self.dataset_replay is None:
            raise ValueError("BiC requires replay (--sample_num > 0)")
        carry = self.bic.params if self.bic is not None else None
        st = self.states[self.cur_state]
        bic_ids, seen_lists, train_ids, replay_ids = carve_bic_val_set(
            self.dataset_train.image_ids, self.dataset_replay.image_ids,
            self.dataset_replay.seen_class_ids, self.dataset_train.seen_class_ids,
            st.new_ids, self.coco, cfg.replay.sample_num, cfg.bic.ratio)
        self.dataset_train.image_ids = train_ids
        self.dataset_replay.image_ids = replay_ids
        bic_ds = BicDataset(self.coco, self.states, self.image_dir, bic_ids, seen_lists)
        bic_loader = BatchLoader(bic_ds, self.cfg.data, shuffle=True, augment=True,
                                 seed=self.cfg.seed, **pmesh.proc_shard(self.mesh))
        counts = [s.num_new_class for s in self.states.states]
        self.bic = BicTrainer(self.model, self.anchors_for, cfg, self.cfg.focal, cfg.bic,
                              counts, self.cur_state, st.num_past_class, bic_loader,
                              mesh=self.mesh)
        if carry is not None:
            self.bic.params = carry

    def _init_agem(self) -> None:
        """A-GEM over the replay loader, on the plain replay-path loss."""
        if not self.cfg.il.agem.enabled:
            self.agem = None
            return
        if self.replay_loader is None:
            raise ValueError("A-GEM requires the replay dataset (--sample_num > 0)")
        st = self.states[self.cur_state]
        statics = LossStatics(num_classes=self.num_classes, num_past_class=st.num_past_class,
                              incremental=False, is_replay=True)
        self.agem = AGem(self.model, self.anchors_for, self.cfg.il, self.cfg.focal, statics,
                         self.replay_loader, mesh=self.mesh)

    def _update_mas(self) -> None:
        """The MAS importance at a state entry: read back from the previous
        state's ``mas_importance`` sidecar (each leaf where its shape
        matches the current parameter, zeros elsewhere), or computed with
        the current model over the training loader and written there."""
        if not self.cfg.il.mas.enabled:
            return
        prev = self.cur_state - 1
        cached = self._agreed_sidecar(prev, "mas_importance")
        if cached is not None:
            self.mas_importance = {}
            for name, p in self.model.named_parameters():
                arr = cached.get(name)
                self.mas_importance[name] = (
                    torch.from_numpy(arr).to(self.device)
                    if arr is not None and tuple(arr.shape) == tuple(p.shape)
                    else torch.zeros_like(p, dtype=torch.float32))
        else:
            self.mas_importance = compute_importance(self.model, self.anchors_for,
                                                     self._make_train_loader(sharded=False),
                                                     mesh=self.mesh)
            self.ckpt.save_array_sidecar(prev, "mas_importance", self.mas_importance)

    def _update_mas_for_next(self) -> None:
        """The finished state's importance (its model, its training loader),
        written as its ``mas_importance`` sidecar."""
        self.mas_importance = compute_importance(self.model, self.anchors_for,
                                                 self._make_train_loader(sharded=False),
                                                 mesh=self.mesh)
        self.ckpt.save_array_sidecar(self.cur_state, "mas_importance", self.mas_importance)

    def _add_pseudo_labels(self) -> None:
        """The teacher's pseudo-labels on the new state's training images;
        the teacher is built for them when distillation did not build it."""
        cfg = self.cfg.il
        if not cfg.pseudo.enabled:
            return
        if self.teacher_model is None:
            self._update_prev_model(force=True)
        self.dataset_train.pseudo_labels = generate_pseudo_labels(
            self.teacher_model, self.dataset_train, self.cfg.data, cfg.pseudo,
            self.states.inverse_label_map(), mesh=self.mesh)
        self.train_loader = self._make_train_loader()

    # ------------------------------------------------------------------
    # train-step variants
    # ------------------------------------------------------------------
    def _loss_statics(self, is_replay: bool,
                      enhance_only: bool = False) -> LossStatics:
        cfg = self.cfg.il
        st = self.states[self.cur_state]
        warm_classifier = self._warm_kind == "output"
        incremental = self.cur_state > 0 and not is_replay and not warm_classifier
        return LossStatics(
            enhance_only=enhance_only,
            num_classes=self.num_classes,
            num_past_class=st.num_past_class,
            incremental=incremental,
            is_replay=is_replay,
            use_distill=cfg.distill.enabled and incremental,
            distill_logits=cfg.distill.logits,
            use_pseudo_progress=cfg.pseudo.enabled and incremental,
            use_enhance_error=cfg.replay.enhance_error,
            enhance_error_method=cfg.replay.enhance_error_method,
            use_enhance_on_new=cfg.enhance_on_new,
            use_classifier_loss=cfg.classifier_loss and incremental
            and cfg.distill.enabled,
            use_mas=cfg.mas.enabled and self.mas_importance is not None
            and not is_replay,
            use_prototype=cfg.prototype.loss and incremental
            and self.prototype_features is not None
            and self.cur_epoch > cfg.prototype.start_epoch,
            ignore_gd=cfg.ignore_gd,
        )

    def _step_statics(self, correction: bool = False) -> StepStatics:
        warm_classifier = self._warm_kind == "output"
        st = self.states[self.cur_state]
        if correction:
            # the final correction: a plain optimizer step per batch, no
            # accumulation, no clip, no A-GEM
            return StepStatics(
                every_iter=1, use_clip=False, warm_classifier=False,
                num_past_class=st.num_past_class,
                num_knowing_class=st.num_knowing_class,
                num_anchors=self.cfg.model.num_anchors,
                use_agem=False,
            )
        return StepStatics(
            every_iter=self.cfg.schedule.every_iter,
            use_clip=not warm_classifier and self.cfg.schedule.grad_clip > 0,
            grad_clip=self.cfg.schedule.grad_clip,
            warm_classifier=warm_classifier,
            num_past_class=st.num_past_class,
            num_knowing_class=st.num_knowing_class,
            num_anchors=self.cfg.model.num_anchors,
            use_agem=self.cfg.il.agem.enabled,
        )

    def _get_step(self, is_replay: bool, frame, correction: bool = False):
        """One train step per (batch kind, warm stage, state, canonical
        frame, prototype phase); ``frame`` is the logical (h, w)."""
        statics = self._loss_statics(is_replay, enhance_only=correction)
        key = (is_replay, self._warm_kind, self.cur_state, frame,
               statics.use_prototype, correction)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.model, self.teacher_model, self._anchors_at(*frame),
                self.cfg.il, self.cfg.focal, statics, self._step_statics(correction),
                mesh=self.mesh)
        return self._steps[key]

    # ------------------------------------------------------------------
    # warm-up
    # ------------------------------------------------------------------
    def warm_up(self, epoch: int) -> None:
        cfg = self.cfg.warmup
        if cfg.warm_stage == 0:
            self.cur_warm_stage = -1
            self._warm_kind = None
            return
        stops = []
        acc = 1
        for e in cfg.warm_epoch[: cfg.warm_stage]:
            acc += e
            stops.append(acc)
        stage = -1
        for idx, stop in enumerate(stops):
            if epoch < stop:
                stage = idx
                break
        old = self._warm_kind
        self.cur_warm_stage = stage
        self._warm_kind = cfg.warm_layers[stage] if stage != -1 else None
        if old != self._warm_kind:
            self._steps.clear()
        self._trainable = trainable_mask(self.model, self._warm_kind)

    # ------------------------------------------------------------------
    # one training batch
    # ------------------------------------------------------------------
    def run_batch(self, batch, is_replay: bool = False,
                  sync_metrics: bool = True,
                  correction: bool = False) -> Dict[str, Any]:
        """One micro-step (the root span ``cldet.train.step``).
        ``sync_metrics=False`` returns the metrics as device tensors, so the
        caller decides when to wait for them."""
        with span("cldet.train.step"):
            step = self._get_step(is_replay, logical_image_hw(batch.images),
                                  correction=correction)
            kwargs = {}
            if self._trainable is not None:
                kwargs["trainable_mask"] = self._trainable
            statics = self._loss_statics(is_replay, enhance_only=correction)
            if statics.use_classifier_loss and self._teacher_class_vectors is not None:
                kwargs["classifier_vectors"] = self._teacher_class_vectors
            if statics.use_pseudo_progress:
                kwargs["pseudo_progress"] = self._pseudo_progress()
            if statics.use_prototype:
                kwargs["prototype_features"] = self._prototype_mean
            if statics.use_mas:
                kwargs["mas_prev_params"] = self.mas_prev_params
                kwargs["mas_importance"] = self.mas_importance
            if (self.cfg.il.agem.enabled and self.agem is not None
                    and not is_replay and not correction):
                if self.agem.replay_grad is None:
                    self.agem.compute_replay_grad(self.model)
                kwargs["replay_grad"] = self.agem.replay_grad
            images, boxes, labels = self._put_batch(batch)
            self.train_state, metrics = step(self.train_state, images, boxes, labels, **kwargs)
            if sync_metrics:
                return {k: float(v) for k, v in metrics.items()}
            return metrics

    def _pseudo_progress(self) -> torch.Tensor:
        """``cur_epoch / max(end_epoch, 1)`` as a float32 0-d tensor on the
        device, made once per (epoch, end epoch)."""
        key = (self.cur_epoch, self.end_epoch)
        if key not in self._progress:
            self._progress[key] = torch.tensor(self.cur_epoch / max(self.end_epoch, 1),
                                               dtype=torch.float32, device=self.device)
        return self._progress[key]

    def set_replay_beta(self, is_replay: bool) -> None:
        """Swap Adam's beta1 for replay batches; a no-op unless the batch
        kind flipped."""
        if self._beta_is_replay == is_replay:
            return
        self._beta_is_replay = is_replay
        if is_replay:
            set_beta1(self.optimizer, self.cfg.il.replay.beta_on_replay,
                      self.cfg.il.replay.beta_on_where)
        else:
            set_beta1(self.optimizer, self.cfg.schedule.beta1, "all")

    def step_scheduler(self, epoch: int) -> None:
        set_learning_rate(self.optimizer, lr_at_epoch(self.cfg.schedule, epoch + 1),
                          self.cfg.schedule.classifier_lr_scale)

    # ------------------------------------------------------------------
    def save(self, epoch: int, epoch_loss: Optional[List[float]] = None) -> None:
        """A half-filled gradient accumulator (every_iter > 1 with an epoch
        length not divisible by it) is not persisted: a resume restarts
        accumulation cleanly. acc_count rides in the meta for diagnostics.
        ``self.save_blocking_s`` is the time the caller was held."""
        t0 = time.perf_counter()
        il_meta = {
            "state": self.cur_state,
            "acc_count": int(self.train_state.acc_count),
            "epoch": epoch,
            "num_classes": self.num_classes,
            "knowing_class_ids": self.states[self.cur_state].knowing_ids,
            "exemplar_ids": (list(self.dataset_replay.image_ids)
                             if self.dataset_replay else []),
            "config": self.cfg.to_json(),
            "loss_hist": [float(x) for x in self.loss_hist],
            "epoch_loss": ([float(x) for x in epoch_loss]
                           if epoch_loss is not None else None),
        }
        if self.bic is not None:
            il_meta["bic"] = {"alphas": self.bic.params.alphas.tolist(),
                              "betas": self.bic.params.betas.tolist()}
        self.ckpt.save(self.cur_state, epoch, self.model, self.optimizer,
                       self.train_state.step, il_meta,
                       async_save=self.cfg.async_checkpoint)
        self.save_blocking_s = time.perf_counter() - t0

    def resume(self, state: int, epoch: int = -1) -> int:
        """Restore the model (parameters and frozen-BN buffers), the
        optimizer (moments, counts, LR and betas of both groups), the
        micro-step count and the loss window from a checkpoint, onto the
        trainer's device. A requested epoch that was never saved falls
        back to the newest saved epoch below it. Returns the epoch."""
        if epoch >= 0 and epoch not in self.ckpt.epochs(state):
            nearest = self.ckpt.nearest_epoch(state, epoch)
            if nearest is None:
                raise FileNotFoundError(
                    f"no checkpoint at or below epoch {epoch} for state {state}")
            print(f"resume: epoch {epoch} not saved; using epoch {nearest}")
            epoch = nearest
        tree, il_meta = self.ckpt.restore(state, epoch)
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.model.zero_grad(set_to_none=True)
        self.train_state.step = int(tree["step"])
        self.train_state.acc_count = 0
        self._beta_is_replay = None
        if il_meta and "bic" in il_meta and self.bic is not None:
            self.bic.params.load(il_meta["bic"])
        if il_meta and il_meta.get("loss_hist"):
            self.loss_hist = collections.deque(il_meta["loss_hist"], maxlen=500)
        return il_meta["epoch"] if il_meta else 0
