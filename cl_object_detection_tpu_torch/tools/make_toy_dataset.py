"""Write a small seeded COCO-json toy set (coloured rectangles on noise),
the stand-in for VOC2007 when no real data is mounted:

    python -m cl_object_detection_tpu_torch.tools.make_toy_dataset --out toy \\
        [--train 16] [--test 8] [--classes a b c] [--seed 0] [--style separable]

Writes ``<out>/train.json``, ``<out>/test.json`` and ``<out>/images/``
through ``utils.toydata.make_toy_dataset``: the JAX tool's JSON (but the
file names' extension) and pixels, as PNG, which the port decodes
without OpenCV or PIL.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from ..utils.toydata import DEFAULT_CLASSES, make_toy_dataset

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="output dataset root dir")
    ap.add_argument("--train", type=int, default=16, help="#train images")
    ap.add_argument("--test", type=int, default=8, help="#test images")
    ap.add_argument("--classes", nargs="+", default=list(DEFAULT_CLASSES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--style", default="legacy", choices=["legacy", "separable"],
                    help="separable = unique hue x pattern per class, "
                         "low-overlap placements (for absolute-mAP runs)")
    args = ap.parse_args(argv)

    for split, n, seed in (("train", args.train, args.seed),
                           ("test", args.test, args.seed + 1)):
        path = make_toy_dataset(
            args.out, num_images=n, classes=args.classes,
            image_size=(args.height, args.width), seed=seed, split=split,
            style=args.style)
        print(f"{split}: {n} images -> {path}")


if __name__ == "__main__":
    main()
