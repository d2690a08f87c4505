"""Static-shape batch loader with background prefetch (the JAX
package's ``data/loader.py``).

  * every batch has ONE static shape: images are bucketed by canonical
    frame (orientation, plus optional ``shape_buckets``), so the count of
    distinct batch shapes stays small;
  * images come out NHWC (float32 normalized, or uint8 with
    ``transfer_dtype="uint8"``; 2x2 or 4x4 space-to-depth for the
    phase-packed stems), GT padded to ``max_boxes`` with -1 sentinels;
    every ``Batch`` field is host numpy (the trainer pins and copies);
  * a background thread assembles the next batches while the device
    computes, and ``num_workers`` threads build the examples of a batch
    concurrently (zlib, numpy and the torch resize release the GIL);
  * augmentation randomness is a pure function of (seed, epoch, image
    index, batch slot), so batches are identical whatever the worker
    count or thread scheduling, and a resumed run sees the same data;
  * on the mesh's data axis (``process_index``, ``process_count``) every
    rank draws the same global schedule and decodes only its contiguous
    slot slice of each global batch; the augmentation stays keyed by the
    global slot, so the slices tile the single-process batch bit for bit;
  * a tool pass on the mesh takes whole batches instead, round robin
    (``round_robin``: batch i of the schedule on rank i mod W), and a rank
    decodes only its own.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import DataConfig
from .dataset import ILDataset
from .transforms import (compute_scale, hflip, normalize_image,
                         pad_annotations, pick_canonical, resize_and_pad,
                         space_to_depth)


@dataclass
class Batch:
    """One static-shape training/eval batch (all arrays host numpy)."""
    images: np.ndarray        # (B, H, W, 3) float32 normalized, or
                              # uint8; (B, H/2, W/2, 12) with
                              # cfg.s2d_stem, (B, H/4, W/4, 64) with
                              # cfg.fused_stem (transforms.
                              # logical_image_hw gives the real size)
    boxes: np.ndarray         # (B, M, 4) xyxy in RESIZED pixels, -1 padded
    labels: np.ndarray        # (B, M) int32, -1 padded
    num_boxes: np.ndarray     # (B,) int32
    num_pseudo: np.ndarray    # (B,) int32 — pseudo-label suffix counts
    scales: np.ndarray        # (B,) float32 resize scale (for unscaling preds)
    image_ids: np.ndarray     # (B,) int64 (-1 for pad slots)
    is_replay: bool = False   # replay batches swap Adam beta1

    @property
    def size(self) -> int:
        return self.images.shape[0]


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: a pinned host copy, then a non-blocking
    copy to the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def put_step_batch(device: torch.device, batch: Batch):
    """(images, boxes, labels) of one step's batch on ``device``: the
    single transfer of the train step, BiC and A-GEM."""
    return tuple(to_device(a, device) for a in (batch.images, batch.boxes, batch.labels))


class BatchLoader:
    """Iterates an ILDataset in frame-bucketed, static-shape batches."""

    def __init__(
        self,
        dataset: ILDataset,
        cfg: DataConfig,
        batch_size: Optional[int] = None,
        shuffle: bool = True,
        augment: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        is_replay: bool = False,
        prefetch: int = 2,
        num_workers: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.drop_last = drop_last
        self.seed = seed
        self.is_replay = is_replay
        self.prefetch = prefetch
        self.num_workers = (num_workers if num_workers is not None
                            else getattr(cfg, "num_workers", 0))
        if process_count > 1 and self.batch_size % process_count:
            raise ValueError(f"batch_size {self.batch_size} not divisible by "
                             f"process_count {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self._pool: Optional[ThreadPoolExecutor] = None
        self._round_robin: Optional[tuple] = None
        self._epoch = 0
        # seconds each batch of the current (or last) epoch took to
        # assemble, in the thread that assembled it
        self.batch_seconds: List[float] = []

    def round_robin(self, rank: int, world: int) -> "BatchLoader":
        """A copy of this loader that yields batches ``rank``, ``rank +
        world``, ... of its schedule, whole, and decodes only those (a
        tool pass's share on the mesh's data axis); the schedule is the
        same on every rank. Trailing batches leave the ranks' counts one
        apart at most."""
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside 0..{world - 1}")
        other = copy.copy(self)
        other._pool = None
        other.batch_seconds = []
        other._round_robin = (rank, world)
        return other

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch so data order is a pure function of
        (seed, state, epoch): a resumed run sees the same batches."""
        self._epoch = epoch

    # ------------------------------------------------------------------
    def _bucketed_batches(self) -> List[List[int]]:
        """Group indices into batches of a single canonical frame.

        Frame-homogeneous batches; group order shuffled per epoch. Short
        final groups wrap around (order[x % len]) unless drop_last.
        """
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self._epoch)
        groups: dict = {}
        for i in range(n):
            groups.setdefault(self._canonical_of(i), []).append(i)
        batches: List[List[int]] = []
        for _, order in sorted(groups.items()):
            if not order:
                continue
            order = list(order)
            if self.shuffle:
                rng.shuffle(order)
            for s in range(0, len(order), self.batch_size):
                group = order[s : s + self.batch_size]
                if len(group) < self.batch_size:
                    if self.drop_last:
                        continue
                    # wrap-around fill
                    group = [order[(s + k) % len(order)] for k in range(self.batch_size)]
                batches.append(group)
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _canonical_of(self, idx: int):
        """Canonical frame of an image from metadata alone (no decode):
        same scale rule + bucket pick as resize_and_pad."""
        h, w = self.dataset.image_size(idx)
        cfg = self.cfg
        scale = compute_scale(h, w, cfg.min_side, cfg.max_side)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        return pick_canonical(nh, nw, cfg.height, cfg.width, cfg.shape_buckets)

    def _make_example(self, idx: int, rng: np.random.RandomState, frame=None):
        ds, cfg = self.dataset, self.cfg
        img = ds.load_image(idx)
        boxes, labels, num_pseudo = ds.load_annotations(idx)
        if self.augment and rng.rand() < cfg.hflip_prob:
            img, boxes = hflip(img, boxes)
        img, boxes, scale = resize_and_pad(
            img, boxes, cfg.min_side, cfg.max_side, cfg.height, cfg.width,
            buckets=cfg.shape_buckets, frame=frame,
        )
        if cfg.transfer_dtype == "uint8":
            # raw 8-bit pixels; the backbone normalizes on device
            # (resize stays float — only the transfer quantizes, max
            # error 0.5/255 per pixel)
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        else:
            img = normalize_image(img, cfg.mean, cfg.std)
        pboxes, plabels, n = pad_annotations(boxes, labels, cfg.max_boxes)
        # pseudo rows are the annotation TAIL (dataset merges them after the
        # real GT); truncation to max_boxes drops from the tail first, so
        # clamp the reported pseudo suffix to what actually survived
        num_pseudo = max(0, min(num_pseudo, n - (len(labels) - num_pseudo)))
        if cfg.s2d_stem:
            # per-sample so the transpose runs inside the decode workers
            # (threaded), not as a serial stall at batch assembly
            img = space_to_depth(img[None])[0]
        elif cfg.fused_stem:
            img = space_to_depth(img[None], factor=4)[0]
        return img, pboxes, plabels, n, num_pseudo, scale, ds.image_ids[idx]

    def _assemble(self, group: Sequence[int], epoch: int) -> Batch:
        # the whole group shares one metadata-derived frame by construction
        # (_bucketed_batches keys on it); forcing it into every example
        # keeps the stack static even if a decoded file disagrees with its
        # COCO-json height/width metadata
        t0 = time.perf_counter()
        frame = self._canonical_of(group[0])
        # this rank's contiguous slice of the global batch; the slot keys
        # stay global
        per = len(group) // self.process_count
        lo = self.process_index * per
        local = list(enumerate(group))[lo:lo + per]

        def make(slot_idx):
            slot, i = slot_idx
            # pure function of (seed, epoch, image, slot): augmentations do
            # not depend on worker count or thread interleaving
            rng = np.random.RandomState(
                (1000003 * self.seed + 7919 * epoch + 131 * int(i) + slot)
                % (2 ** 31)
            )
            return self._make_example(i, rng, frame=frame)

        if self.num_workers and self.num_workers > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.num_workers)
            ex = list(self._pool.map(make, local))
        else:
            ex = [make(si) for si in local]
        batch = Batch(
            images=np.stack([e[0] for e in ex]),
            boxes=np.stack([e[1] for e in ex]),
            labels=np.stack([e[2] for e in ex]),
            num_boxes=np.asarray([e[3] for e in ex], np.int32),
            num_pseudo=np.asarray([e[4] for e in ex], np.int32),
            scales=np.asarray([e[5] for e in ex], np.float32),
            image_ids=np.asarray([e[6] for e in ex], np.int64),
            is_replay=self.is_replay,
        )
        self.batch_seconds.append(time.perf_counter() - t0)
        return batch

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        # same frame-grouped count as __iter__'s batching (wrap-around fill
        # keeps short groups, so the count is ceil per group — independent
        # of the per-epoch shuffle). Computed without RNG/shuffling and
        # cached on the dataset's id list, since callers use len() per
        # epoch (progress bars, A-GEM averaging).
        ids = self.dataset.image_ids
        key = (len(ids), hash(tuple(ids)), self.batch_size, self.drop_last)
        cached = getattr(self, "_len_cache", None)
        if cached is not None and cached[0] == key:
            return self._local_count(cached[1])
        sizes: Dict = {}
        for i in range(len(self.dataset)):
            k = self._canonical_of(i)
            sizes[k] = sizes.get(k, 0) + 1
        if self.drop_last:
            n = sum(sz // self.batch_size for sz in sizes.values())
        else:
            n = sum(-(-sz // self.batch_size) for sz in sizes.values())
        self._len_cache = (key, n)
        return self._local_count(n)

    def _local_count(self, n: int) -> int:
        """This loader's share of ``n`` scheduled batches."""
        if self._round_robin is None:
            return n
        rank, world = self._round_robin
        return len(range(rank, n, world))

    def __iter__(self) -> Iterator[Batch]:
        batches = self._bucketed_batches()
        if self._round_robin is not None:
            rank, world = self._round_robin
            batches = batches[rank::world]
        epoch = self._epoch
        self._epoch += 1
        self.batch_seconds = []
        if self.prefetch <= 0:
            for group in batches:
                yield self._assemble(group, epoch)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()   # abandoned-iterator shutdown: without
                                     # it, a consumer that stops early (epoch
                                     # exception, unconsumed replay iter)
                                     # leaves the worker blocked on q.put
                                     # forever, pinning decoded batches

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for group in batches:
                    if not put(self._assemble(group, epoch)):
                        return
            except BaseException as e:  # surface errors on the consumer side
                put(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancel.set()
