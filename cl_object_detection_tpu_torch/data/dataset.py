"""Host-side dataset family for incremental learning (the JAX package's
``data/dataset.py``) on :class:`CocoJson`.

  * the train split sees only the CURRENT state's new classes; the test
    split (or ``use_all_class``) sees all knowing classes;
  * labels are contiguous ids built from the FINAL state's knowing order,
    so they are stable across states;
  * annotations outside the state's class subset, crowd annotations and
    degenerate boxes (w < 1 or h < 1) are skipped;
  * pseudo-labels (per-image COCO dicts) are appended after real GT;
  * boxes convert xywh -> xyxy;
  * ``use_data_ratio`` truncates the non-test image list.

Images are decoded by ``data/image_io.read_image`` (RGB, /255).
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..states import ILStates
from .coco import CocoJson
from .image_io import read_image


class ILDataset:
    """COCO-json dataset filtered to the current IL state's class subset."""

    def __init__(
        self,
        coco: CocoJson,
        states: ILStates,
        image_dir: str,
        split: str = "train",
        start_state: int = 0,
        use_data_ratio: float = 1.0,
        use_all_class: bool = False,
        pseudo_labels: Optional[Dict[int, List[dict]]] = None,
    ):
        self.coco = coco
        self.states = states
        self.image_dir = image_dir
        self.split = split
        self.cur_state = start_state
        self.use_data_ratio = use_data_ratio
        self.use_all_class = use_all_class
        self.pseudo_labels = pseudo_labels or {}

        if split == "test" or use_all_class:
            self.seen_class_ids = list(states[start_state].knowing_ids)
        else:
            self.seen_class_ids = list(states[start_state].new_ids)

        # contiguous label maps from the FINAL state (stable across states)
        self.label_of_cat = states.label_map()
        self.cat_of_label = states.inverse_label_map()

        self.image_ids: List[int] = []
        self.update_image_ids()

    # ------------------------------------------------------------------
    def update_image_ids(self) -> None:
        ids = self.coco.get_imgs_by_cats(self.seen_class_ids)
        if self.split != "test":
            ids = ids[: int(len(ids) * self.use_data_ratio)]
        self.image_ids = ids

    def next_state(self) -> None:
        if self.cur_state + 1 >= len(self.states):
            raise ValueError("next state doesn't exist")
        self.cur_state += 1
        if self.split == "test" or self.use_all_class:
            self.seen_class_ids = list(self.states[self.cur_state].knowing_ids)
        else:
            self.seen_class_ids = list(self.states[self.cur_state].new_ids)
        # the previous state's pseudo-labels must not leak into the new
        # state's GT (similarity pass, BiC carve, and pseudo generation
        # all read the dataset before new pseudo-labels are added)
        self.pseudo_labels = {}
        self.update_image_ids()

    def __len__(self) -> int:
        return len(self.image_ids)

    # ------------------------------------------------------------------
    def load_image(self, index: int) -> np.ndarray:
        """(H, W, 3) float32 RGB in [0, 1]."""
        info = self.coco.imgs[self.image_ids[index]]
        path = os.path.join(self.image_dir, info["file_name"])
        return read_image(path).astype(np.float32) / 255.0

    def load_annotations(self, index: int):
        """Returns (boxes xyxy (N,4) f32, labels (N,) i32, num_pseudo)."""
        img_id = self.image_ids[index]
        boxes: List[List[float]] = []
        labels: List[int] = []
        for ann in self.coco.get_anns_by_img(img_id):
            if ann.get("iscrowd", 0):
                continue
            if ann["category_id"] not in self.seen_class_ids:
                continue
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.label_of_cat[ann["category_id"]])
        num_pseudo = 0
        for ann in self.pseudo_labels.get(img_id, []):
            x, y, w, h = ann["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(self.label_of_cat[ann["category_id"]])
            num_pseudo += 1
        if boxes:
            return (
                np.asarray(boxes, np.float32),
                np.asarray(labels, np.int32),
                num_pseudo,
            )
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), 0

    def image_aspect_ratio(self, index: int) -> float:
        info = self.coco.imgs[self.image_ids[index]]
        return float(info["width"]) / float(info["height"])

    def image_size(self, index: int):
        info = self.coco.imgs[self.image_ids[index]]
        return int(info["height"]), int(info["width"])

    @property
    def num_new_classes(self) -> int:
        return self.states[self.cur_state].num_new_class


class ReplayDataset(ILDataset):
    """Exemplar memory over old-class images."""

    def __init__(self, coco, states, image_dir, per_num: int = 1, seed: int = 0):
        super().__init__(coco, states, image_dir, split="train", start_state=0,
                         use_all_class=True)
        self.per_num = per_num
        self.cur_state: Optional[int] = None  # type: ignore[assignment]
        self.seen_class_ids = []
        self.image_ids = []
        self._rng = random.Random(seed)

    def update_image_ids(self) -> None:  # replay never auto-populates
        pass

    def reset_by_img_ids(self, per_num: int, img_ids: Sequence[int]) -> None:
        """Infer the state from len(img_ids)/per_num."""
        self.image_ids = list(img_ids)
        self.per_num = per_num
        self.seen_class_ids = []
        if not self.image_ids:
            return
        class_num = len(self.image_ids) // self.per_num
        for s in range(len(self.states)):
            if self.states[s].num_knowing_class == class_num:
                self.cur_state = s + 1
                self.seen_class_ids = list(self.states[s].knowing_ids)
                return
        raise ValueError("length of img_ids doesn't match any state")

    def reset_explicit(self, per_num: int, img_ids: Sequence[int], state: int) -> None:
        """Like reset_by_img_ids but with the state given explicitly.

        Inferring the state from len(img_ids)/per_num breaks whenever a
        sampler returns fewer than per_num exemplars for a scarce class;
        the trainer always knows the state, so it passes it.
        """
        self.image_ids = list(img_ids)
        self.per_num = per_num
        self.cur_state = state
        self.seen_class_ids = list(self.states[state - 1].knowing_ids)

    def _future_img_ids(self, from_state: int) -> Set[int]:
        future: List[int] = []
        for i in range(from_state, len(self.states)):
            future.extend(self.states[i].new_ids)
        return set(self.coco.get_imgs_by_cats(future))

    def sample_imgs(self, cat_ids: Sequence[int], limit: Set[int]) -> None:
        """Random per-class draw avoiding `limit` and already-chosen images."""
        for cid in cat_ids:
            pool = sorted(set(self.coco.get_imgs_by_cats(cid)) - limit - set(self.image_ids))
            if not pool:
                raise ValueError(f"class id {cid}: no images distinct from other classes")
            self.image_ids.extend(self._rng.sample(pool, min(self.per_num, len(pool))))

    def reset_by_state(self, state: int) -> None:
        if state == 0:
            raise ValueError("initial state cannot sample pictures")
        self.cur_state = state
        self.seen_class_ids = list(self.states[state - 1].knowing_ids)
        self.image_ids = []
        self.sample_imgs(self.seen_class_ids, self._future_img_ids(state))

    def next_state(self) -> None:
        self.cur_state = 0 if self.cur_state is None else self.cur_state
        self.cur_state += 1
        if self.cur_state >= len(self.states):
            raise ValueError(f"state {self.cur_state} doesn't exist in replay dataset")
        new_ids = self.states[self.cur_state - 1].new_ids
        self.seen_class_ids = list(self.seen_class_ids) + list(new_ids)
        self.sample_imgs(self.seen_class_ids, self._future_img_ids(self.cur_state))


class BicDataset(ILDataset):
    """Held-out validation set for BiC: explicit (image_id, per-image seen
    class list) pairs."""

    def __init__(self, coco, states, image_dir,
                 image_ids: Sequence[int], seen_class_ids: Sequence[Sequence[int]]):
        super().__init__(coco, states, image_dir, split="train", start_state=0,
                         use_all_class=True)
        self.image_ids = list(image_ids)
        self.per_image_seen = [set(s) for s in seen_class_ids]

    def update_image_ids(self) -> None:
        pass

    def load_annotations(self, index: int):
        img_id = self.image_ids[index]
        seen = self.per_image_seen[index]
        boxes: List[List[float]] = []
        labels: List[int] = []
        for ann in self.coco.get_anns_by_img(img_id):
            if ann.get("iscrowd", 0) or ann["category_id"] not in seen:
                continue
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.label_of_cat[ann["category_id"]])
        if boxes:
            return np.asarray(boxes, np.float32), np.asarray(labels, np.int32), 0
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), 0
