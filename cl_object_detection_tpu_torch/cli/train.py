"""Training CLI (the JAX package's ``cli/train.py``).

    python -m cl_object_detection_tpu_torch.cli.train \\
        --train_json data/train.json --image_dir data/images \\
        --scenario 20 --depth 50 --batch_size 8 --fused_stem true \\
        --transfer_dtype uint8 --end_epoch 2 [--cpu]

The JAX package's flags; the dataset layout is
<root_dir>/<dataset>/{train,test}.json + images/ (or explicit
--train_json / --image_dir). Runs on the CUDA device unless ``--cpu`` is
given, and raises when there is none. Writes ``params.json`` beside the
checkpoints, resumes a ``--start_epoch`` > 1 from the newest checkpoint
at or below the epoch before it, and trains states ``--start_state`` to
``--end_state`` (``--scenario 15 5 --end_state 1 --distill true``: state
0, then state 1 from the expanded classifier with the state-0 model as
teacher; ``--start_state 1`` enters state 1 from the state-0
checkpoint); ``--val true`` then validates the last epoch
(``cli.validate.run_validation``, with the checkpoint's BiC correction
under ``--bic true``). ``main`` returns the trainer.

The mesh (``cli/common.start_ranks``, ``parallel/mesh.py``):

    # one rank per visible card (or --num_data N CPU ranks with --cpu)
    python -m cl_object_detection_tpu_torch.cli.train ... --mesh true
    # a num_data x num_model mesh: the head trunks split over --num_model ranks
    python -m cl_object_detection_tpu_torch.cli.train ... --mesh true --num_data 2 --num_model 2
    # or each rank started by hand (two on one card share it over gloo)
    python -m cl_object_detection_tpu_torch.cli.train ... --mesh true \
        --coordinator_address 127.0.0.1:29500 --num_processes 2 --process_id 0
    # or under torchrun
    torchrun --nproc_per_node 2 -m cl_object_detection_tpu_torch.cli.train ... --mesh true

Every rank trains its data index's slice of each global batch
(``--batch_size`` is the global size and must divide by ``num_data``);
with ``--num_model`` the ranks of one data index split the head trunks'
convs (column- and row-parallel, JAX's ``head_tp_spec``) and keep their
blocks of those leaves' Adam moments; rank 0 writes the checkpoints,
``params.json`` and the records. When ``main`` started the ranks itself it
returns None. ``--zero1 true`` also shards the Adam moments over the data
axis (ZeRO-1, ``train/optim.py``): each rank updates its blocks and an
all-gather reassembles the parameters; the checkpoints are bit for bit
those of the same mesh without it. Without a data axis it is a no-op.
Without ``--mesh`` ``--num_model`` is ignored.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    from .common import (add_train_flags, args_to_config, print_il_info,
                         resolve_dataset_paths, start_ranks)

    add_train_flags(parser)
    a = parser.parse_args(argv)
    cfg = args_to_config(a)

    import torch

    from ..train.loop import train_process
    from ..train.trainer import ILTrainer
    from ..utils.profiling import stop_trace_guarded
    from ..utils.recorder import Recorder

    device = start_ranks(a, main, argv)
    if device is None:
        return None
    if cfg.debug:
        # fail at the operation whose backward produced a NaN
        torch.autograd.set_detect_anomaly(True)

    train_json, image_dir = resolve_dataset_paths(a, "train")
    trainer = ILTrainer(cfg, train_json, image_dir, workdir=a.root_dir, device=device)
    if a.print_il_info and trainer.primary:
        print_il_info(cfg, trainer.states)

    # the config beside the checkpoints
    if trainer.primary:
        cfg_path = os.path.join(trainer.ckpt.state_dir(cfg.il.start_state), "params.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())

    recorder = Recorder(
        log_root=os.path.join(a.root_dir, "runs"),
        scenario_tag="_".join(str(s) for s in cfg.il.scenario),
        description=cfg.description,
        enabled=cfg.record and trainer.primary,
    )
    try:
        # resume: start_epoch > 1 restores that state's checkpoint; with
        # --save_every k>1 the exact epoch may be missing, so the newest
        # saved epoch <= start_epoch-1 stands in and the loop restarts there
        if a.start_epoch and a.start_epoch > 1:
            actual = trainer.ckpt.nearest_epoch(cfg.il.start_state, a.start_epoch - 1)
            if actual is None:
                raise FileNotFoundError(
                    f"--start_epoch {a.start_epoch}: no checkpoint at or below "
                    f"epoch {a.start_epoch - 1} for state {cfg.il.start_state}")
            if actual != a.start_epoch - 1:
                if trainer.primary:
                    print(f"--start_epoch {a.start_epoch}: epoch {a.start_epoch - 1} "
                          f"not saved; resuming from epoch {actual}")
                cfg = cfg.replace(start_epoch=actual + 1)
                trainer.cfg = cfg
            trainer.resume(cfg.il.start_state, actual)
        train_process(trainer, recorder)
    finally:
        # close a profiler trace left open by a mid-epoch exception
        stop_trace_guarded()
        recorder.close()
        if cfg.debug:
            torch.autograd.set_detect_anomaly(False)

    if cfg.val_after_train:
        from .validate import run_validation

        # mirror train_process's clamp: end_state < start_state trains
        # only start_state, so that's the state to validate
        end_state = cfg.il.end_state if cfg.il.end_state is not None else cfg.il.start_state
        end_state = max(end_state, cfg.il.start_state)
        last = trainer.ckpt.latest_epoch(end_state)
        if last is None:
            print(f"warning: no checkpoint for state {end_state}; "
                  "skipping chained validation")
        else:
            run_validation(a, state=end_state, epochs=[last], device=device)
    return trainer


if __name__ == "__main__":
    main()
