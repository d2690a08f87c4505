"""Export a trained checkpoint as a self-contained serving artifact (the
JAX package's ``cli/export.py``).

    python -m cl_object_detection_tpu_torch.cli.export --root_dir <run> \\
        --scenario 20 --state 0 [--epoch -1] [--batch 8] \\
        [--platforms cuda cpu] --out <artifact_dir> [--cpu]

Freezes the whole predict path (the architecture rebuilt from the run's
``params.json``, the checkpoint's weights in the program's state, and
the decode / top-k / NMS post-process) with ``torch.export``, one
``predict.<device type>.pt2`` per platform beside ``meta.json``
(``eval/deploy.py``). ``cli.serve --from_export <dir>``, or any process
that calls ``eval.deploy.load_artifact``, serves it with no access to
the checkpoint tree or the port's model code; the kernels ride in the
program as ``torch.library`` operators (``ops/library.py``).

One artifact per (batch, frame): exported programs are shape-static.
Runs on the CUDA device unless ``--cpu`` is given, and raises when there
is none.
"""
from __future__ import annotations

import argparse


def get_parser():
    from ..eval.deploy import PLATFORMS

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_dir", default=".")
    p.add_argument("--scenario", nargs="+", default=["20"])
    p.add_argument("--state", type=int, default=0)
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--depth", type=int, default=None,
                   help="override the backbone depth from params.json")
    p.add_argument("--batch", type=int, default=8,
                   help="static batch size baked into the artifact")
    p.add_argument("--score_thresh", type=float, default=0.05)
    p.add_argument("--topk_method", default="exact",
                   choices=["exact", "approx"])
    p.add_argument("--quantize", action="store_true",
                   help="int8 dynamic-PTQ convs baked into the program")
    p.add_argument("--bic", action="store_true",
                   help="bake the checkpoint's BiC bias correction in")
    p.add_argument("--transfer_dtype", default="uint8",
                   choices=["float32", "uint8"],
                   help="input dtype of the exported program (uint8 = "
                        "raw frames + on-device normalization)")
    p.add_argument("--platforms", nargs="*", default=None, choices=PLATFORMS,
                   help="device types to export for, each traced on that "
                        "device (which must be present), e.g. --platforms "
                        "cuda cpu; default: the device this run uses")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--cpu", action="store_true")
    return p


def main(argv=None):
    a = get_parser().parse_args(argv)
    import os

    from ..eval.deploy import export_predict, load_serving_bundle, save_artifact

    bundle = load_serving_bundle(a.root_dir, a.scenario, a.state, a.epoch, a.depth,
                                 device="cpu" if a.cpu else None)
    blobs, meta = export_predict(
        bundle,
        batch=a.batch,
        score_thresh=a.score_thresh,
        topk_method=a.topk_method,
        quantize=a.quantize,
        transfer_dtype=a.transfer_dtype,
        platforms=a.platforms,
        bic=a.bic,
    )
    save_artifact(a.out, blobs, meta)
    size = sum(len(b) for b in blobs.values())
    print(f"exported {size / 1e6:.1f} MB artifact to "
          f"{os.path.abspath(a.out)} (R{meta['depth']}, batch {a.batch}, "
          f"frame {meta['height']}x{meta['width']}, "
          f"platforms {meta['platforms']})")
    return meta


if __name__ == "__main__":
    main()
