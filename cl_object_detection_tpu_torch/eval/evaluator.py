"""Evaluation orchestration (the JAX package's ``eval/evaluator.py``):
batched predict -> COCO-json result rows -> per-class AP/recall, with the
reference's artifact layout.

The test split's ``ILDataset`` feeds a ``BatchLoader`` (no shuffle, no
augmentation, short groups wrap-filled); each batch goes to the model's
device and through ``make_predict_fn``. Where the JAX package takes
``(model, variables)``, the port takes a model (its weights live in it).

One loop serves one process and the mesh (``mesh=``, the model on this
rank's device): each rank decodes and predicts its data index's slice of
every batch on whole weights (the counterpart of the JAX package's
``make_sharded_predict_fn``, the batch split over the data axis only:
detection is per image, so the predict needs no collective); the rows of
model index 0's ranks (the other ranks of a model group predict the same
slice), tagged by (batch, global slot), are gathered on every rank with
``all_gather_object`` (the identity for one process) and deduplicated in
batch and slot order, so the rows equal one process's.
The COCO protocol (``evaluate``) needs no collective; ``cli.validate``
runs it on rank 0.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from ..config import DataConfig, PredictConfig
from ..data.coco import CocoJson
from ..data.dataset import ILDataset
from ..data.loader import BatchLoader, to_device
from ..states import ILStates
from ..parallel.mesh import active, all_gather_object, is_primary, proc_shard
from .coco_eval import CocoProtocolEval, EvalResult
from .predictor import detections_to_coco, make_predict_fn


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _progress(loader, enabled: bool) -> Iterable:
    """``loader`` under a tqdm bar when tqdm imports, else with a line
    printed every 10 batches."""
    if not enabled:
        return loader
    try:
        import tqdm

        return tqdm.tqdm(loader, total=len(loader))
    except ImportError:
        pass

    def lines():
        total, t0 = len(loader), time.perf_counter()
        for i, batch in enumerate(loader, 1):
            yield batch
            if i % 10 == 0 or i == total:
                print(f"eval: batch {i}/{total} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return lines()


class Evaluator:
    """Evaluate a model checkpoint on one IL state's test split."""

    def __init__(
        self,
        coco: CocoJson,
        states: ILStates,
        image_dir: str,
        data_cfg: DataConfig,
        predict_cfg: PredictConfig,
        state_index: int = 0,
        eval_on_train: bool = False,
    ):
        self.coco = coco
        self.states = states
        self.state_index = state_index
        self.predict_cfg = predict_cfg
        self.data_cfg = data_cfg
        split = "train" if eval_on_train else "test"
        self.dataset = ILDataset(
            coco, states, image_dir, split=split, start_state=state_index,
            use_all_class=True,
        )
        self.loader = BatchLoader(
            self.dataset, data_cfg, shuffle=False, augment=False,
            drop_last=False,
        )
        self.label_to_cat = states.inverse_label_map()

    # ------------------------------------------------------------------
    def _predict(self, fns: Dict, device: torch.device, mesh,
                 progress: bool) -> Dict[Any, List[dict]]:
        """Every key's COCO rows of the split: ``fns[key](images)`` on each
        batch's images on ``device`` (on the mesh, this rank's slice of
        every batch). The rows of every (batch, global slot) are gathered
        from the ranks, then kept from the first slot of each image in
        batch and slot order: the static loader wrap-fills short groups by
        REPEATING images, across and within batches, so each image's rows
        must come from exactly one slot (else duplicate COCO rows corrupt
        AP)."""
        loader = (BatchLoader(self.dataset, self.data_cfg, shuffle=False, augment=False,
                              drop_last=False, **proc_shard(mesh))
                  if active(mesh) else self.loader)
        lo = loader.process_index * (loader.batch_size // loader.process_count)
        mine = []                               # (batch, slot, image id, {key: rows})
        for b, batch in enumerate(_progress(loader, progress and is_primary(mesh))):
            images = to_device(batch.images, device)
            per_key = {key: detections_to_coco(fn(images), batch, self.label_to_cat,
                                               self.predict_cfg.score_thresh, by_slot=True)
                       for key, fn in fns.items()}
            for j, img_id in enumerate(batch.image_ids.tolist()):
                mine.append((b, lo + j, img_id, {k: v[j] for k, v in per_key.items()}))
        if mesh is not None and mesh.model_index:
            mine = []                   # the model group's rows come from its model index 0
        entries = sorted((e for rank_rows in all_gather_object(mesh, mine) for e in rank_rows),
                         key=lambda e: e[:2])
        seen: set = set()
        results: Dict[Any, List[dict]] = {k: [] for k in fns}
        for _, _, img_id, rows in entries:
            if img_id < 0 or img_id in seen:
                continue
            seen.add(img_id)
            for k in fns:
                results[k].extend(rows[k])
        return results

    def predict_dataset(self, model, progress: bool = False, mesh=None,
                        bic_correct=None) -> List[dict]:
        """Run batched inference over the whole split; returns COCO result
        rows (deduped — the static loader wraps short batches).

        ``bic_correct``: optional logits->logits callable (the BiC bias
        correction) applied before the sigmoid. ``mesh``: the data axis
        (module docstring); every rank gets all the rows."""
        predict = make_predict_fn(model, self.predict_cfg, bic_correct=bic_correct)
        return self._predict({0: predict}, _device_of(model), mesh, progress)[0]

    def predict_dataset_multi(
        self,
        models_by_key: Dict,
        progress: bool = False,
        mesh=None,
        bic_correct_by_key: Optional[Dict] = None,
    ) -> Dict[Any, List[dict]]:
        """Evaluate SEVERAL checkpoints in one pass over the data: each
        decoded batch goes through every key's model before the next
        batch, so the split is decoded once. As in the JAX package, every
        key runs the same predict form: a BiC correction (an object
        exposing per-class ``.scale`` and ``.offset``, as the JAX
        package's ``bic_correct_from_meta`` gives) rides in as runtime
        vectors on the logits, the identity for keys without one.

        ``models_by_key``: {key: model}, all on one device (this rank's on
        the mesh's data axis, ``mesh=``)."""
        bic_correct_by_key = bic_correct_by_key or {}
        devices = {_device_of(m) for m in models_by_key.values()}
        if len(devices) != 1:
            raise ValueError(f"the models lie on several devices: {sorted(map(str, devices))}")
        device = devices.pop()
        num_knowing = self.states[self.state_index].num_knowing_class
        identity = (torch.ones(num_knowing, device=device),
                    torch.zeros(num_knowing, device=device))
        fns = {}
        for key, model in models_by_key.items():
            predict = make_predict_fn(model, self.predict_cfg)
            bc = bic_correct_by_key.get(key)
            scale, offset = ((torch.as_tensor(bc.scale, device=device),
                              torch.as_tensor(bc.offset, device=device))
                             if bc is not None else identity)
            fns[key] = (lambda im, f=predict, s=scale, o=offset: f(im, s, o))
        return self._predict(fns, device, mesh, progress)

    def evaluate(self, results: List[dict], ignore_other_img: bool = False,
                 use_native: bool = True) -> EvalResult:
        ev = CocoProtocolEval(self.coco, self.dataset.image_ids)
        cat_ids = self.states[self.state_index].knowing_ids
        return ev.evaluate(results, cat_ids, ignore_other_img=ignore_other_img,
                           use_native=use_native)

    # ------------------------------------------------------------------
    def run(
        self,
        model,
        result_dir: Optional[str] = None,
        epoch: int = 0,
        dataset_name: str = "voc2007",
        bic_correct=None,
    ) -> EvalResult:
        results = self.predict_dataset(model, bic_correct=bic_correct)
        if result_dir:
            os.makedirs(result_dir, exist_ok=True)
            path = os.path.join(result_dir, f"{dataset_name}_results_epoch{epoch}.json")
            with open(path, "w") as f:
                json.dump(results, f)
        return self.evaluate(results)
