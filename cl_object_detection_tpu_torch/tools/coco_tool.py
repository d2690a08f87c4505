"""Inspect a COCO-json annotation file through ``data.coco.CocoJson``:

    python -m cl_object_detection_tpu_torch.tools.coco_tool stats       ann.json
    python -m cl_object_detection_tpu_torch.tools.coco_tool classes     ann.json
    python -m cl_object_detection_tpu_torch.tools.coco_tool imgs-by-cat ann.json --cats dog cat
    python -m cl_object_detection_tpu_torch.tools.coco_tool cats-by-img ann.json --imgs 1 2 3

``stats`` prints the per-class table with pandas.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from ..data.coco import CocoJson

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cmd", choices=["stats", "classes", "imgs-by-cat", "cats-by-img"])
    p.add_argument("json_path")
    p.add_argument("--cats", nargs="*", default=[])
    p.add_argument("--imgs", nargs="*", type=int, default=[])
    a = p.parse_args(argv)

    coco = CocoJson(a.json_path)
    if a.cmd == "stats":
        print(coco.stats_frame().to_string())
        print(f"\ntotal: {len(coco.imgs)} images, {len(coco.anns)} objects, "
              f"{len(coco.cats)} classes")
    elif a.cmd == "classes":
        for cid in sorted(coco.classes):
            print(f"{cid:4d}  {coco.classes[cid]}")
    elif a.cmd == "imgs-by-cat":
        out = coco.get_imgs_by_cats(coco.cat_name_to_id(a.cats))
        print(f"{len(out)} images:", out[:50], "..." if len(out) > 50 else "")
    else:
        out = coco.get_cats_by_imgs(a.imgs)
        print([f"{c}:{coco.classes[c]}" for c in out])


if __name__ == "__main__":
    main()
