"""Evaluation orchestration (the JAX package's ``eval/evaluator.py``):
batched predict -> COCO-json result rows -> per-class AP/recall, with the
reference's artifact layout.

The test split's ``ILDataset`` feeds a ``BatchLoader`` (no shuffle, no
augmentation, short groups wrap-filled); each batch goes to the model's
device and through ``make_predict_fn``. Where the JAX package takes
``(model, variables)``, the port takes a model (its weights live in it).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import DataConfig, PredictConfig
from ..data.coco import CocoJson
from ..data.dataset import ILDataset
from ..data.loader import BatchLoader
from ..states import ILStates
from .coco_eval import CocoProtocolEval, EvalResult
from .predictor import detections_to_coco, make_predict_fn

MESH_NOT_PORTED = ("multi-device evaluation (mesh=) is not ported yet: "
                   "ROADMAP §1 item 6")


def _first_occurrence_slots(batch, seen):
    """(keep_slots, batch_new_ids): one True slot per image — the static
    loader wrap-fills short canonical-frame groups by REPEATING images
    WITHIN a batch, so both cross-batch and in-batch repeats must emit
    rows from exactly one slot (else duplicate COCO rows corrupt AP)."""
    keep = []
    batch_seen = set()
    for i in batch.image_ids.tolist():
        keep.append(i >= 0 and i not in seen and i not in batch_seen)
        batch_seen.add(i)
    batch_seen.discard(-1)
    return keep, batch_seen


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _to_device(images: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(images))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


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
    def predict_dataset(self, model, progress: bool = False, mesh=None,
                        bic_correct=None) -> List[dict]:
        """Run batched inference over the whole split; returns COCO result
        rows (deduped — the static loader wraps short batches).

        ``bic_correct``: optional logits->logits callable (the BiC bias
        correction) applied before the sigmoid."""
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        predict = make_predict_fn(model, self.predict_cfg, bic_correct=bic_correct)
        device = _device_of(model)
        seen: set = set()
        results: List[dict] = []
        for batch in _progress(self.loader, progress):
            det = predict(_to_device(batch.images, device))
            keep, batch_seen = _first_occurrence_slots(batch, seen)
            results.extend(detections_to_coco(
                det, batch, self.label_to_cat, self.predict_cfg.score_thresh,
                keep_slots=keep,
            ))
            seen |= batch_seen
        return results

    def predict_dataset_multi(
        self,
        models_by_key: Dict,
        progress: bool = False,
        mesh=None,
        bic_correct_by_key: Optional[Dict] = None,
    ) -> Dict[int, List[dict]]:
        """Evaluate SEVERAL checkpoints in one pass over the data: each
        decoded batch goes through every key's model before the next
        batch, so the split is decoded once. As in the JAX package, every
        key runs the same predict form: a BiC correction (an object
        exposing per-class ``.scale`` and ``.offset``, as the JAX
        package's ``bic_correct_from_meta`` gives) rides in as runtime
        vectors on the logits, the identity for keys without one.

        ``models_by_key``: {key: model}, all on one device."""
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
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
        seen: set = set()
        results: Dict[int, List[dict]] = {k: [] for k in models_by_key}
        for batch in _progress(self.loader, progress):
            keep, batch_seen = _first_occurrence_slots(batch, seen)
            images = _to_device(batch.images, device)
            for key in models_by_key:
                det = fns[key](images)
                results[key].extend(detections_to_coco(
                    det, batch, self.label_to_cat,
                    self.predict_cfg.score_thresh, keep_slots=keep,
                ))
            seen |= batch_seen
        return results

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
