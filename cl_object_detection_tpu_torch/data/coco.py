"""Pure-Python COCO-json index (own copy of the JAX package's
``data/coco.py``): the query surface the trainer needs, in plain dict/set
code, with no pycocotools. ``stats_frame`` imports pandas only when
called."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Set, Union


class CocoJson:
    """Index over a COCO-format annotation file (or an already-loaded dict)."""

    def __init__(self, source: Union[str, dict]):
        if isinstance(source, str):
            with open(source) as f:
                data = json.load(f)
        else:
            data = source
        self.dataset = data

        self.imgs: Dict[int, dict] = {im["id"]: im for im in data.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in data.get("categories", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in data.get("annotations", [])}

        # name <-> id
        self.classes: Dict[int, str] = {cid: c["name"] for cid, c in self.cats.items()}
        self.classes_inverse: Dict[str, int] = {v: k for k, v in self.classes.items()}

        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, Set[int]] = defaultdict(set)
        for a in data.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
            self.cat_to_imgs[a["category_id"]].add(a["image_id"])

    # -- id/name maps ---------------------------
    def cat_id_to_name(self, ids: Union[int, Iterable[int]]):
        if isinstance(ids, int):
            return self.classes[ids]
        return [self.classes[i] for i in ids]

    def cat_name_to_id(self, names: Union[str, Iterable[str]], sort: bool = False):
        if isinstance(names, str):
            return self.classes_inverse[names]
        out = [self.classes_inverse[n] for n in names]
        return sorted(out) if sort else out

    # -- queries --------------------------------
    def get_imgs_by_cats(self, cat_ids: Union[int, Iterable[int]]) -> List[int]:
        """Union of image ids containing any of the given categories."""
        if isinstance(cat_ids, int):
            cat_ids = [cat_ids]
        out: Set[int] = set()
        for c in cat_ids:
            out |= self.cat_to_imgs[c]
        return sorted(out)

    def get_cats_by_imgs(self, img_ids: Union[int, Iterable[int]], sort: bool = True) -> List[int]:
        """Distinct category ids present in the given images."""
        if isinstance(img_ids, int):
            img_ids = [img_ids]
        out: Set[int] = set()
        for i in img_ids:
            out |= {a["category_id"] for a in self.img_to_anns[i]}
        return sorted(out) if sort else list(out)

    def get_anns_by_img(self, img_id: int) -> List[dict]:
        return list(self.img_to_anns[img_id])

    # -- per-class statistics ------------------
    def image_count_per_class(self) -> Dict[str, int]:
        return {self.classes[c]: len(v) for c, v in self.cat_to_imgs.items()}

    def object_count_per_class(self) -> Dict[str, int]:
        counts: Dict[str, int] = defaultdict(int)
        for a in self.anns.values():
            counts[self.classes[a["category_id"]]] += 1
        return dict(counts)

    def stats_frame(self):
        """Per-class image/object counts as a pandas DataFrame (optional dep)."""
        import pandas as pd

        imgs = self.image_count_per_class()
        objs = self.object_count_per_class()
        names = sorted(self.classes.values())
        return pd.DataFrame(
            {
                "images": [imgs.get(n, 0) for n in names],
                "objects": [objs.get(n, 0) for n in names],
            },
            index=names,
        )
