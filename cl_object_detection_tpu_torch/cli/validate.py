"""Validation CLI (the JAX package's ``cli/validate.py``).

    python -m cl_object_detection_tpu_torch.cli.validate \\
        --root_dir run --test_json data/test.json --image_dir data/images \\
        --scenario 20 --state 0 --epoch 1 2 [--cpu]

Runs batched inference + per-class COCO-protocol AP/recall for each
requested epoch checkpoint, writes result JSONs and the decline-vs-
upper-bound CSV. ``--just_val`` re-scores existing result JSONs without
re-predicting. ``--save_upper_bound`` stores this run's result as the
forgetting baseline. Runs on the CUDA device unless ``--cpu`` is given,
and raises when there is none. Checkpoints are the port's own
(``utils/checkpoint.py``, under ``<root_dir>/checkpoint`` as the port's
trainer writes them); ``--torch_ckpt`` evaluates a reference-format
state dict (``.pt`` or ``.npz``) instead, loaded once for every epoch.
``--bic true`` applies each checkpoint's BiC correction (its
``il_meta["bic"]`` scalars, ``il/bic.bic_correct_from_meta``) and adds
``_bic`` to the result JSONs and the decline CSV; an epoch without BiC
state is predicted uncorrected and written without the suffix, and
``--torch_ckpt`` (no meta) ignores the flag with a warning.

``--mesh true`` (and the process flags, or ``torchrun``, as for
``cli.train``) predicts on the mesh: the batch splits over the data axis
only, as JAX's ``cli/validate.py`` shards it; each rank predicts its data
index's slice of every batch on whole weights (``Evaluator`` with
``mesh=``, ``--bic`` and ``--quantize`` included), so the ranks of a
model group predict the same slice and only model index 0's rows are
gathered; rank 0 scores them and writes every output; every rank returns
rank 0's results. The batch size must divide by ``num_data``. ``--zero1``
is accepted and ignored (there is no optimizer), as in JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional


def get_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    from .common import add_train_flags, str2bool

    add_train_flags(parser)
    # NB: --bic comes from add_train_flags; on the validate CLI it means
    # "apply the checkpoint's BiC bias correction at inference"
    parser.add_argument("--state", type=int, default=0)
    parser.add_argument("--epoch", type=int, nargs="+", default=[-1])
    parser.add_argument("--threshold", type=float, default=0.05)
    parser.add_argument("--topk_method", default="exact",
                        choices=["exact", "approx"],
                        help="pre-NMS candidate selection ('approx': the "
                             "exact stable top-k of the float32 scores, what "
                             "lax.approx_max_k computes off the TPU)")
    parser.add_argument("--quantize", type=str2bool, default=False,
                        help="int8 dynamic-PTQ convs on the predict path "
                             "(ops/quant.py); A/B against fp before "
                             "trusting a deployment")
    parser.add_argument("--eval_on_train", type=str2bool, default=False)
    parser.add_argument("--just_val", type=str2bool, default=False)
    # result-folder management: --new_folder nests this run's outputs in
    # their own subfolder of state{N} — named --specific_folder, else a
    # YYYY-mm-dd-HH-MM timestamp. Off by default so the no-flag result
    # paths stay deterministic. --output_csv false skips the decline CSV.
    parser.add_argument("--output_csv", type=str2bool, default=True)
    parser.add_argument("--new_folder", type=str2bool, default=False)
    parser.add_argument("--specific_folder", default="None")
    parser.add_argument("--ignore_other_img", type=str2bool, default=False)
    parser.add_argument("--save_upper_bound", type=str2bool, default=False)
    # --torch_ckpt comes from add_train_flags; here it means "evaluate a
    # REFERENCE-trained .pt (or its .npz conversion) instead of one of
    # the port's checkpoints"
    return parser


def run_validation(a, state: Optional[int] = None, epochs: Optional[List[int]] = None,
                   device=None):
    """The validation of ``a``'s flags on ``device`` (default: the one
    ``resolve_device`` gives), on the data axis's ranks under ``--mesh``
    (the process group already joined)."""
    from .. import resolve_device
    from ..config import PredictConfig
    from ..data.coco import CocoJson
    from ..eval.evaluator import Evaluator
    from ..eval.report import decline_csv, load_upper_bound, save_upper_bound
    from ..models.retinanet import create_retinanet
    from ..parallel import mesh as pmesh
    from ..states import ILStates
    from ..utils.checkpoint import CheckpointManager
    from .common import args_to_config, resolve_dataset_paths

    if device is None:
        device = resolve_device("cpu" if getattr(a, "cpu", False) else None)
    cfg = args_to_config(a)
    # --zero1 is a training flag: ignored here
    mesh = (pmesh.create_mesh(dataclasses.replace(cfg.mesh, zero1=False), device)
            if cfg.mesh.enabled else None)
    if mesh is not None:
        if cfg.data.batch_size % mesh.num_data:
            raise SystemExit(f"--mesh: batch_size {cfg.data.batch_size} not divisible by "
                             f"the data axis ({mesh.num_data})")
        print(pmesh.describe(mesh))
    primary = pmesh.is_primary(mesh)
    state = state if state is not None else getattr(a, "state", 0)
    epochs = epochs if epochs is not None else getattr(a, "epoch", [-1])
    threshold = getattr(a, "threshold", 0.05)

    split = "train" if getattr(a, "eval_on_train", False) else "test"
    json_path, image_dir = resolve_dataset_paths(a, split)
    if not os.path.exists(json_path) and split == "test":
        json_path, image_dir = resolve_dataset_paths(a, "train")
        print(f"warning: no test split found; evaluating on {json_path}")

    coco = CocoJson(json_path)
    states = ILStates(
        list(coco.classes.values()), coco.classes_inverse,
        list(cfg.il.scenario), cfg.il.shuffle_class, cfg.il.shuffle_seed,
    )
    # where the port's trainer keeps them (cli.train: workdir = root_dir)
    ckpt = CheckpointManager(os.path.join(a.root_dir, cfg.checkpoint_dir),
                             cfg.il.scenario, cfg.keep_every, mesh=mesh)
    num_classes = states[state].num_knowing_class

    predict_cfg = PredictConfig(
        score_thresh=threshold,
        topk_method=getattr(a, "topk_method", "exact"),
        quantize=getattr(a, "quantize", False),
    )
    evaluator = Evaluator(
        coco, states, image_dir, cfg.data, predict_cfg, state_index=state,
        eval_on_train=(split == "train"),
    )

    result_dir = os.path.join(
        a.root_dir, "val_result",
        "_".join(str(s) for s in cfg.il.scenario), f"state{state}",
    )
    if getattr(a, "new_folder", False):
        specific = getattr(a, "specific_folder", "None")
        if specific and specific != "None":
            folder = specific
        else:
            from datetime import datetime

            folder = datetime.now().strftime("%Y-%m-%d-%H-%M")
        folder = pmesh.broadcast_object(mesh, folder)     # rank 0's timestamp
        result_dir = os.path.join(result_dir, folder)
        if primary:
            print(f"results folder: {result_dir}")
    if primary:
        os.makedirs(result_dir, exist_ok=True)
        _copy_run_artifacts(ckpt.state_dir(state), result_dir)

    use_bic = bool(getattr(a, "bic", False))
    suffix = "_bic" if use_bic else ""

    def result_json_path(epoch, with_bic=None):
        # NB: distinct name — ``json_path`` above is the DATASET json
        sfx = suffix if with_bic is None else ("_bic" if with_bic else "")
        return os.path.join(result_dir, f"{a.dataset}_results_epoch{epoch}{sfx}.json")

    def new_model():
        return create_retinanet(cfg.model, num_classes, device=device)

    # resolve epoch list, split into cached rows vs checkpoints to predict
    rows_by_epoch = {}
    to_predict = {}
    bic_by_epoch = {}
    torch_model = None
    for epoch in epochs:
        if getattr(a, "torch_ckpt", None):
            # no checkpoint of the port is needed (or may exist): label the
            # results with the requested epoch (0 for the -1 default) and
            # load the reference checkpoint ONCE for the whole epoch list
            epoch = 0 if epoch == -1 else epoch
            if torch_model is None:
                from ..models.convert import load_reference_checkpoint

                torch_model = new_model()
                load_reference_checkpoint(torch_model, a.torch_ckpt,
                                          allow_pickle=getattr(a, "trust_torch_ckpt", False))
                if use_bic:
                    print("warning: --bic ignored for --torch_ckpt (no meta)")
            to_predict[epoch] = torch_model
            continue
        if epoch == -1:
            epoch = ckpt.latest_epoch(state)
            if epoch is None:
                raise SystemExit(
                    f"no checkpoints for state {state} under "
                    f"{ckpt.state_dir(state)}")
        if getattr(a, "just_val", False):
            # re-score-only contract: a missing cached json is an error,
            # not a silent re-predict
            if not os.path.exists(result_json_path(epoch)):
                raise SystemExit(
                    f"--just_val: no cached results at "
                    f"{result_json_path(epoch)}")
            with open(result_json_path(epoch)) as f:
                rows_by_epoch[epoch] = json.load(f)
        else:
            tree, il_meta = ckpt.restore(state, epoch)
            model = new_model()
            model.load_state_dict(tree["model"])
            to_predict[epoch] = model
            if use_bic:
                from ..il.bic import bic_correct_from_meta

                counts = [s.num_new_class for s in states.states]
                bc = bic_correct_from_meta(il_meta, counts, num_classes)
                if bc is None:
                    # uncorrected rows must not land in the _bic json
                    # (--just_val would read them as corrected)
                    print(f"warning: --bic requested but the epoch {epoch} checkpoint "
                          "carries no BiC state; writing its uncorrected rows without "
                          "the _bic suffix")
                else:
                    bic_by_epoch[epoch] = bc

    if to_predict:
        # all requested epochs share ONE decode pass over the split
        predicted = evaluator.predict_dataset_multi(to_predict, progress=True, mesh=mesh,
                                                    bic_correct_by_key=bic_by_epoch)
        for epoch, rows in predicted.items():
            if primary:
                with open(result_json_path(epoch, use_bic and epoch in bic_by_epoch),
                          "w") as f:
                    json.dump(rows, f)
            rows_by_epoch[epoch] = rows

    if not primary:
        # rank 0 scores the rows and writes the rest; every rank returns
        # its results
        return pmesh.broadcast_object(mesh, None)
    results = {}
    for epoch in sorted(rows_by_epoch):
        res = evaluator.evaluate(rows_by_epoch[epoch],
                                 getattr(a, "ignore_other_img", False))
        results[epoch] = res
        print(f"epoch {epoch}: mAP50={res.mean_ap50:.4f} AR={res.mean_recall:.4f}")
        for name in sorted(res.ap50):
            print(f"  {name:<14} AP={res.ap50[name]:.4f} AR={res.recall[name]:.4f}")

    ub_path = os.path.join(a.root_dir, "val_result", "upper_bound.json")
    if getattr(a, "save_upper_bound", False) and results:
        save_upper_bound(ub_path, results[max(results)])
        print(f"saved upper bound to {ub_path}")

    if getattr(a, "output_csv", True):
        csv_name = ("val_result_" + "_".join(str(e) for e in sorted(results))
                    + suffix + ".csv")
        decline_csv(
            results,
            states[state].knowing_names,
            states[state].num_past_class,
            upper_bound=load_upper_bound(ub_path),
            out_path=os.path.join(result_dir, csv_name),
        )
        print(f"wrote {os.path.join(result_dir, csv_name)}")
    _write_hparams_summary(a, cfg, state, results)
    return pmesh.broadcast_object(mesh, results)


def _copy_run_artifacts(state_dir: str, result_dir: str) -> None:
    """Copy the training run's config + exemplar artifacts next to the
    results (the reference copies params.txt / il_hparams.pickle /
    examplar.txt / examplar.png into the result dir)."""
    import shutil

    for name in ("params.json", "examplar.txt", "examplar.png"):
        src = os.path.join(state_dir, name)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(result_dir, name))


def _write_hparams_summary(a, cfg, state: int, results) -> None:
    """TensorBoard hparams + final-metric summary: one hparams entry per
    validation run keyed by the IL-method knobs, with the newest epoch's
    mAP/AR as the metrics."""
    if not results or not getattr(a, "record", True):
        return
    from ..utils.recorder import Recorder

    best_epoch = max(results)
    res = results[best_epoch]
    il = cfg.il
    hparams = {
        "scenario": "_".join(str(s) for s in il.scenario),
        "state": state,
        "epoch": best_epoch,
        "bic": bool(getattr(a, "bic", False)),
        "distill": il.distill.enabled,
        "distill_logits": il.distill.logits,
        "sample_num": il.replay.sample_num,
        "sample_method": il.replay.sample_method,
        "mix_data": il.replay.mix_data,
        "enhance_error": il.replay.enhance_error,
        "mas": il.mas.enabled,
        "agem": il.agem.enabled,
        "bic_trained": il.bic.enabled,
        "pseudo_label": il.pseudo.enabled,
        "prototype_loss": il.prototype.loss,
        "classifier_loss": il.classifier_loss,
        "init_method": il.init_method,
        "depth": cfg.model.depth,
        "lr": cfg.schedule.lr,
        "threshold": getattr(a, "threshold", 0.05),
    }
    metrics = {
        "hparam/mAP50": float(res.mean_ap50),
        "hparam/mean_recall": float(res.mean_recall),
    }
    rec = Recorder(
        log_root=os.path.join(a.root_dir, "runs"),
        scenario_tag="val_" + hparams["scenario"] + f"_state{state}",
        description=getattr(a, "description", "None"),
        enabled=True,
    )
    rec.add_hparams(hparams, metrics)
    rec.close()


def main(argv=None):
    from .common import start_ranks

    parser = get_parser()
    a = parser.parse_args(argv)
    device = start_ranks(a, main, argv)
    if device is None:
        return None
    return run_validation(a, device=device)


if __name__ == "__main__":
    main()
