"""The input pipeline's rate (the JAX package's ``tools/bench_loader.py``):
the port's train-path loader (``data/loader.BatchLoader``: decode,
resize, pad, flip, collate in its worker threads, prefetched) over a
synthetic VOC-shaped toy set, each batch copied to the device as the
trainer copies it (``data.loader.put_step_batch``), in images/s per
worker count, over epochs 2 and later (epoch 1 warms the page cache):

    python -m cl_object_detection_tpu_torch.tools.bench_loader [--images 96] \\
        [--batch 8] [--workers 0 2 4] [--height 375 --width 500] \\
        [--shape_buckets 608x832] [--epochs 3] [--cpu]

The set is PNG (``utils.toydata``), which ``data/image_io.py`` decodes
itself: the card's machine has neither OpenCV nor PIL for JPEG, so the
figure is PNG decoding's, not the JAX tool's JPEG's; the records say so.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch

from ..utils import benchlib
from . import common


def measure(root: str, json_path: str, a, workers: int, device) -> float:
    """Images/s of epochs 2.. through a loader with ``workers`` threads."""
    from ..config import DataConfig
    from ..data.coco import CocoJson
    from ..data.dataset import ILDataset
    from ..data.loader import BatchLoader, put_step_batch
    from ..states import ILStates
    from ..utils.toydata import DEFAULT_CLASSES

    coco = CocoJson(json_path)
    states = ILStates(list(DEFAULT_CLASSES), coco.classes_inverse, [5])
    ds = ILDataset(coco, states, root + "/images", split="train")
    buckets = tuple(tuple(int(d) for d in b.split("x")) for b in a.shape_buckets.split(",") if b)
    cfg = DataConfig(batch_size=a.batch, shape_buckets=buckets, transfer_dtype="uint8",
                     fused_stem=a.fused)
    loader = BatchLoader(ds, cfg, shuffle=True, augment=True, num_workers=workers)
    n_img, t0 = 0, None
    for epoch in range(a.epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            put_step_batch(device, batch)
            if t0 is not None:
                n_img += batch.images.shape[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)    # the epoch's copies have landed
        if epoch == 0:
            t0 = time.perf_counter()
    return n_img / (time.perf_counter() - t0)


def main(argv=None) -> None:
    from ..utils.toydata import make_toy_dataset

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", type=int, default=96)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 2],
                    help="decode worker threads (0 = in the loader's thread)")
    ap.add_argument("--height", type=int, default=375, help="source image height (VOC's)")
    ap.add_argument("--width", type=int, default=500)
    ap.add_argument("--shape_buckets", default="608x832",
                    help="canonical frames, comma-separated HxW ('' = the defaults)")
    ap.add_argument("--fused", action="store_true",
                    help="4x4 space-to-depth batches (the fused stem's input)")
    ap.add_argument("--epochs", type=int, default=3,
                    help="epochs; the first warms the page cache and is not counted")
    common.add_device_flag(ap)
    a = ap.parse_args(argv)
    device = common.device_of(a)

    root = tempfile.mkdtemp(prefix="bench_loader_")
    try:
        t0 = time.perf_counter()
        json_path = make_toy_dataset(root, num_images=a.images,
                                     image_size=(a.height, a.width), seed=0)
        made_s = time.perf_counter() - t0
        for workers in a.workers:
            rate = measure(root, json_path, a, workers, device)
            out = {"metric": "loader_images_per_sec", "value": rate, "unit": "images/s",
                   "workers": workers, "images": a.images, "batch": a.batch,
                   "source_size": f"{a.height}x{a.width}",
                   "frames": a.shape_buckets or "defaults", "fused": a.fused,
                   "image_format": "PNG, decoded by data/image_io.py (no OpenCV or PIL "
                                   "on the card's machine; the JAX tool decodes JPEG)",
                   "dataset_seconds": made_s}
            benchlib.emit(out, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
