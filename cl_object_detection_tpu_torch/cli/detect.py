"""Single-image / image-dir detection CLI (the JAX package's
``cli/detect.py``): load a checkpoint, run the full
resize->normalize->forward->decode->NMS path per image, draw the boxes
above a score threshold with OpenCV, save annotated copies.

    python -m cl_object_detection_tpu_torch.cli.detect \\
        --image_dir imgs/ --out_dir out/ --scenario 20 --state 0 \\
        --class_list classes.csv [--cpu]

Images are read by ``data/image_io.read_image`` and resized by
``data/transforms.resize_and_pad``; drawing and writing need ``cv2``
(``main`` raises naming it when it does not import). Runs on the CUDA
device unless ``--cpu`` is given, and raises when there is none.
Checkpoints are the port's own (under ``<root_dir>/checkpoint`` as the
port's trainer writes them); ``--torch_ckpt`` runs a reference-format
state dict instead. ``--bic`` applies the checkpoint's BiC correction
(its ``il_meta["bic"]`` scalars; ignored with a warning for
``--torch_ckpt``, which carries no meta).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional


def load_class_list(path: Optional[str], coco_json: Optional[str]):
    """Category table from a CSV 'name,id' per line or a COCO json.
    Returns ({cat_id: name}, {name: cat_id})."""
    if path:
        names = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, idx = line.split(",")[:2]
                names[int(idx)] = name
        return names, {v: k for k, v in names.items()}
    if coco_json:
        from ..data.coco import CocoJson

        c = CocoJson(coco_json)
        return dict(c.classes), dict(c.classes_inverse)
    raise ValueError("need --class_list or --train_json")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--out_dir", default="detect_out")
    parser.add_argument("--class_list", default=None)
    parser.add_argument("--train_json", default=None)
    parser.add_argument("--root_dir", default=".")
    parser.add_argument("--scenario", nargs="+", default=["20"])
    parser.add_argument("--state", type=int, default=0)
    parser.add_argument("--epoch", type=int, default=-1)
    parser.add_argument("--depth", type=int, default=50)
    parser.add_argument("--score_thresh", type=float, default=0.5)
    parser.add_argument("--bic", action="store_true",
                        help="apply the checkpoint's BiC bias correction")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 dynamic-PTQ convs (ops/quant.py)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA device; "
                             "without one, the run raises)")
    parser.add_argument("--torch_ckpt", default=None,
                        help="a REFERENCE-trained .pt checkpoint (or its "
                             ".npz conversion) to run instead of one of the "
                             "port's checkpoints")
    parser.add_argument("--num_classes", type=int, default=None,
                        help="class count for --torch_ckpt (default: "
                             "len(class list))")
    a = parser.parse_args(argv)
    try:
        import cv2
    except ImportError as e:
        raise ImportError("cli.detect draws the boxes and writes the annotated "
                          "images with OpenCV (cv2), which does not import here") from e

    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import DataConfig, ModelConfig, PredictConfig
    from ..data.image_io import read_image
    from ..data.transforms import normalize_image, resize_and_pad
    from ..eval.predictor import make_predict_fn
    from ..models.retinanet import create_retinanet
    from ..states import ILStates
    from ..utils.checkpoint import CheckpointManager

    device = resolve_device("cpu" if a.cpu else None)
    classes, classes_inverse = load_class_list(a.class_list, a.train_json)
    # model labels are FINAL-state CONTIGUOUS ids in the ILStates knowing
    # order — NOT category-id order (e.g. scenario '15 1' forces 'train'
    # into slot 15); map through the same label map the evaluator uses
    states = ILStates(
        [classes[i] for i in sorted(classes)], classes_inverse,
        list(a.scenario),
    )
    label_to_cat = states.inverse_label_map()

    def name_of(label: int) -> str:
        cat = label_to_cat.get(int(label))
        return classes.get(cat, str(label))

    bic_correct = None
    if a.torch_ckpt:
        from ..models.convert import load_reference_checkpoint

        num_classes = a.num_classes or len(classes)
        model = create_retinanet(ModelConfig(depth=a.depth), num_classes, device=device)
        load_reference_checkpoint(model, a.torch_ckpt)
        if a.bic:
            print("warning: --bic ignored for --torch_ckpt (no meta)")
    else:
        # where cli.train writes them (its workdir is --root_dir)
        ckpt = CheckpointManager(
            os.path.join(a.root_dir, os.path.join(a.root_dir, "checkpoint")), a.scenario)
        tree, il_meta = ckpt.restore(a.state, a.epoch)
        num_classes = il_meta["num_classes"] if il_meta else len(classes)
        model = create_retinanet(ModelConfig(depth=a.depth), num_classes, device=device)
        model.load_state_dict(tree["model"])
        if a.bic:
            from ..il.bic import bic_correct_from_meta

            # the per-state new-class counts come from the scenario flag,
            # the knowing count from the checkpoint's meta
            counts = [int(s) if str(s).isdigit() else 1 for s in a.scenario]
            bic_correct = bic_correct_from_meta(il_meta, counts, num_classes)
            if bic_correct is None:
                print("warning: --bic requested but the checkpoint carries no BiC state")
    predict = make_predict_fn(model, PredictConfig(quantize=a.quantize),
                              bic_correct=bic_correct)
    dcfg = DataConfig()

    os.makedirs(a.out_dir, exist_ok=True)
    names = sorted(
        f for f in os.listdir(a.image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    counts = {}
    for fname in names:
        path = os.path.join(a.image_dir, fname)
        rgb8 = read_image(path)
        img, _, scale = resize_and_pad(
            rgb8.astype(np.float32) / 255.0, np.zeros((0, 4), np.float32),
            dcfg.min_side, dcfg.max_side, dcfg.height, dcfg.width,
        )
        img = normalize_image(img)
        det = predict(torch.from_numpy(img[None]).to(device))
        boxes = det.boxes[0].cpu().numpy() / scale
        scores = det.scores[0].cpu().numpy()
        labels = det.labels[0].cpu().numpy()
        keep = det.valid[0].cpu().numpy() & (scores > a.score_thresh)

        bgr = np.ascontiguousarray(rgb8[..., ::-1])
        for i in np.where(keep)[0]:
            x1, y1, x2, y2 = boxes[i].astype(int)
            caption = f"{name_of(labels[i])} {scores[i]:.2f}"
            cv2.rectangle(bgr, (x1, y1), (x2, y2), (0, 0, 255), 2)
            cv2.putText(bgr, caption, (x1, max(y1 - 5, 12)),
                        cv2.FONT_HERSHEY_PLAIN, 1.2, (0, 255, 0), 2)
        out_path = os.path.join(a.out_dir, fname)
        if not cv2.imwrite(out_path, bgr):
            raise OSError(f"cv2.imwrite could not write {out_path}")
        counts[fname] = int(keep.sum())
        print(f"{fname}: {counts[fname]} detections -> {out_path}")
    return counts


if __name__ == "__main__":
    main()
