"""Shared CLI plumbing (the JAX package's ``cli/common.py``): the same
flags -> TrainConfig for ``cli.train`` and ``cli.validate``. ``--cpu``
selects the CPU device in place of the JAX backend switch.
``start_ranks`` puts a ``--mesh`` run on the mesh (``parallel/mesh.py``):
with the process flags (``--coordinator_address host:port --num_processes
N --process_id r``) this process is one rank of N; under ``torchrun`` its
environment says which; otherwise ``--mesh true`` starts ``num_data x
num_model`` ranks, one per visible device (``--num_data`` defaults to the
cards // ``--num_model``; on the CPU with ``--cpu``, to 1) and waits for
them. Without ``--mesh`` (or the process flags) ``--num_model`` is
ignored, as JAX's ``MeshConfig(enabled=False)`` ignores it."""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

from ..config import (
    AGEMConfig,
    BiCConfig,
    DataConfig,
    DistillConfig,
    FocalConfig,
    ILConfig,
    MASConfig,
    MeshConfig,
    ModelConfig,
    PredictConfig,
    PrototypeConfig,
    PseudoLabelConfig,
    ReplayConfig,
    ScheduleConfig,
    TrainConfig,
    WarmupConfig,
)


def _parse_shape_buckets(spec: str, frame_h: int, frame_w: int):
    """Parse/validate 'HxW,HxW,...': landscape form (h <= w), dims %32,
    positive, and strictly smaller than the default frame (pick_canonical
    only ever selects smaller frames — anything else is a silent no-op)."""
    out = []
    for part in spec.split(","):
        if not part:
            continue
        dims = part.split("x")
        if len(dims) != 2:
            raise SystemExit(f"--shape_buckets: '{part}' is not HxW")
        try:
            h, w = (int(d) for d in dims)
        except ValueError:
            raise SystemExit(f"--shape_buckets: '{part}' dims must be integers")
        if h <= 0 or w <= 0:
            raise SystemExit(f"--shape_buckets: '{part}' dims must be positive")
        if h > w:
            raise SystemExit(
                f"--shape_buckets: '{part}' must be landscape form (h <= w);"
                " portrait images use the transpose automatically")
        if h % 32 or w % 32:
            raise SystemExit(f"--shape_buckets: '{part}' dims must be %32")
        if h * w >= frame_h * frame_w:
            raise SystemExit(
                f"--shape_buckets: '{part}' is not smaller than the default "
                f"{frame_h}x{frame_w} frame and would never be selected; "
                "raise --image_height/--image_width instead")
        out.append((h, w))
    return tuple(out)


def str2bool(v: str) -> bool:
    t = str(v).lower()
    if t in ("1", "true", "yes", "t", "y"):
        return True
    if t in ("0", "false", "no", "f", "n"):
        return False
    # a typo must not silently disable an experiment flag
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def add_train_flags(parser: argparse.ArgumentParser) -> None:
    """The JAX package's training flags, same names and defaults."""
    p = parser
    p.add_argument("--root_dir", default=".")
    p.add_argument("--dataset", default="voc2007")
    p.add_argument("--train_json", default=None, help="explicit COCO json (overrides root layout)")
    p.add_argument("--test_json", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--start_epoch", type=int, default=1)
    p.add_argument("--end_epoch", type=int, default=None)
    p.add_argument("--start_state", type=int, default=0)
    p.add_argument("--end_state", type=int, default=None)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--gamma", type=float, default=2.0)
    p.add_argument("--record", type=str2bool, default=True)
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs (+ always the final one)")
    p.add_argument("--profile", default=None,
                   help="capture a torch.profiler trace of epoch 2 into DIR "
                        "(trace.json for Perfetto, kernels.txt, summary.json)")
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--val", type=str2bool, default=False)
    p.add_argument("--torch_ckpt", default=None,
                   help="seed from a reference .pt checkpoint: weights "
                        "always; Adam moments + scheduler LR on a "
                        "same-state resume (--start_epoch > 1)")
    p.add_argument("--trust_torch_ckpt", action="store_true",
                   help="permit full unpickling of --torch_ckpt (needed "
                        "for scheduler state; executes code in the file)")
    # warm up
    p.add_argument("--warm_stage", type=int, default=0)
    p.add_argument("--warm_epoch", type=int, nargs="*", default=[10, 10])
    p.add_argument("--warm_layers", nargs="*", default=["output", "resnet"])
    # IL
    p.add_argument("--scenario", nargs="+", default=["20"])
    p.add_argument("--shuffle_class", type=str2bool, default=False)
    p.add_argument("--distill", type=str2bool, default=False)
    p.add_argument("--distill_logits", type=str2bool, default=False)
    p.add_argument("--sample_num", type=int, default=0)
    p.add_argument("--sample_method", default="herd")
    p.add_argument("--prototype_herd_mode", default="slots",
                   choices=["slots", "classmean"])
    p.add_argument("--sample_batch_size", type=int, default=5)
    p.add_argument("--mas", type=str2bool, default=False)
    p.add_argument("--mas_ratio", type=float, default=1.0)
    p.add_argument("--agem", type=str2bool, default=False)
    p.add_argument("--agem_refresh_every", type=int, default=1)
    p.add_argument("--bic", type=str2bool, default=False)
    p.add_argument("--bic_ratio", type=float, default=0.1)
    p.add_argument("--enhance_error", type=str2bool, default=False)
    p.add_argument("--enhance_error_method", default="L2")
    p.add_argument("--init_method", default="mean")
    p.add_argument("--scail", type=str2bool, default=False,
                   help="SCAIL classifier standardization at state entry "
                        "(rescale new-class filters to the old classes' "
                        "ranked-mean weight profile)")
    p.add_argument("--decrease_positive", type=float, default=1.0)
    p.add_argument("--decrease_positive_by_IOU", type=str2bool, default=False)
    p.add_argument("--ignore_GD", type=str2bool, default=False)
    p.add_argument("--new_ignore_past_class", type=str2bool, default=False)
    p.add_argument("--enhance_on_new", type=str2bool, default=False)
    p.add_argument("--classifier_loss", type=str2bool, default=False)
    p.add_argument("--no_clip", type=str2bool, default=False)
    p.add_argument("--beta_on_replay", type=float, default=0.9)
    p.add_argument("--beta_on_where", default="all")
    p.add_argument("--persuado_label", type=str2bool, default=False)
    p.add_argument("--clip_loss", type=str2bool, default=True)
    p.add_argument("--clip_cls_loss", type=float, default=0.03)
    p.add_argument("--clip_replay_cls_loss", type=float, default=0.003)
    p.add_argument("--prototype_loss", type=str2bool, default=False)
    p.add_argument("--final_correction", type=str2bool, default=False)
    p.add_argument("--mix_data", type=str2bool, default=False)
    p.add_argument("--mix_data_start", type=int, default=0)
    p.add_argument("--every_iter", type=int, default=2)
    p.add_argument("--output_examplar", type=str2bool, default=True)
    p.add_argument("--print_il_info", type=str2bool, default=True,
                   help="print IL flags + per-state class table before "
                        "training")
    p.add_argument("--description", default="None")
    # lr
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--scheduler_milestone", type=int, nargs="+", default=[40])
    p.add_argument("--scheduler_decay", type=float, default=0.1)
    # model/data
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--pretrained", default=None,
                   help="converted backbone npz/pt ('none'/'false' = scratch)")
    p.add_argument("--remat", type=str2bool, default=False,
                   help="recompute backbone blocks in the backward (bigger "
                        "batches)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--new_state_epoch", type=int, default=60)
    p.add_argument("--use_data_ratio", type=float, default=1.0)
    p.add_argument("--ignore_past_class", type=str2bool, default=False)
    p.add_argument("--image_height", type=int, default=640)
    p.add_argument("--image_width", type=int, default=1024)
    p.add_argument("--shape_buckets", default="",
                   help="extra canonical frames 'HxW,HxW,...' (landscape "
                        "form, dims %%32); images pad into the smallest "
                        "fitting frame — less conv waste, one compiled "
                        "step per frame")
    p.add_argument("--s2d_stem", type=str2bool, default=False,
                   help="host 2x2 space-to-depth batches for the "
                        "phase-packed stem conv")
    p.add_argument("--fused_stem", type=str2bool, default=False,
                   help="host 4x4 space-to-depth batches; the whole stem "
                        "(conv+BN+ReLU+pool) runs as one fused kernel")
    p.add_argument("--transfer_dtype", default="float32",
                   choices=["float32", "uint8"],
                   help="uint8: ship raw 8-bit pixels and normalize on "
                        "device — 4x less host->device infeed")
    p.add_argument("--min_side", type=int, default=None,
                   help="resize min-side target (default: image_height - 32)")
    p.add_argument("--max_side", type=int, default=None,
                   help="resize max-side cap (default: image_width)")
    p.add_argument("--seed", type=int, default=0)
    # parallelism: the mesh's data and model axes and ZeRO-1 (parallel/mesh.py)
    p.add_argument("--mesh", type=str2bool, default=False,
                   help="data- (and with --num_model, head-tensor-) parallel over ranks, "
                        "one per device (NCCL when each has a card, gloo on the CPU or on "
                        "a shared card)")
    p.add_argument("--num_model", type=int, default=1,
                   help="with --mesh: model-axis size, the head trunks' convs split over "
                        "its ranks (fpn_channels must divide by it)")
    p.add_argument("--num_data", type=int, default=-1,
                   help="data-axis size (-1: the visible devices // --num_model; with "
                        "--cpu, 1)")
    p.add_argument("--zero1", type=str2bool, default=False,
                   help="with --mesh: shard the Adam moments over the data axis (each "
                        "rank updates its blocks, then an all-gather); a no-op without a "
                        "data axis; cli.validate ignores it")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0's rendezvous (or a file:// URL of a store "
                        "that every rank reaches): this process is rank --process_id of "
                        "--num_processes")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--just_train_classifier", type=str2bool, default=False,
                   help="train only the cls/reg output layers (the reference's"
                        " just_train_classifier.py experiment)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device; without "
                        "one, the run raises)")


def uses_mesh(a: argparse.Namespace) -> bool:
    """Whether the run is on the mesh's data axis: ``--mesh``, or the
    process flags of several processes."""
    return bool(a.mesh or a.coordinator_address or (a.num_processes or 1) > 1)


def _run_rank(rank: int, entry, argv: List[str], nprocs: int, address: str,
              threads: int) -> None:
    os.environ["OMP_NUM_THREADS"] = str(threads)     # init_distributed divides it
    entry(list(argv) + ["--coordinator_address", address, "--num_processes", str(nprocs),
                        "--process_id", str(rank)])


def start_ranks(a: argparse.Namespace, entry, argv: Optional[List[str]]):
    """This process's device, after joining the mesh's process group when
    the run has several ranks; or None when this process started the ranks
    itself (``--mesh true`` with no process flags, outside ``torchrun``),
    ran ``entry(argv + process flags)`` in each and waited for them (the
    first that raises ends the others, and the error is raised here). The
    ranks it starts meet through a file store in a temporary directory of
    this process's, which no other process can take from them (a TCP port
    picked free could be taken before rank 0 binds it), and share this
    process's torch threads (as ``OMP_NUM_THREADS``, which
    ``parallel.mesh.init_distributed`` divides among a host's CPU ranks)."""
    import shutil
    import sys
    import tempfile

    import torch

    from ..parallel import mesh as pmesh

    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if a.mesh and not a.coordinator_address and not torchrun:
        num_model = max(1, a.num_model)
        if a.cpu:
            n = (a.num_data if a.num_data > 0 else 1) * num_model
        else:
            from .. import resolve_device

            resolve_device(None)                 # raises without CUDA
            cards = torch.cuda.device_count()
            n = (a.num_data if a.num_data > 0 else cards // num_model) * num_model
            if n > cards:
                raise RuntimeError(f"{n} ranks (--num_data x --num_model) but {cards} CUDA "
                                   "device(s): a rank would have no device of its own")
        if n > 1:
            argv = list(sys.argv[1:] if argv is None else argv)
            folder = tempfile.mkdtemp(prefix="mesh_rendezvous_")
            address = f"file://{os.path.join(folder, 'store')}"
            print(f"mesh: starting {n} ranks (rendezvous {address})", flush=True)
            try:
                pmesh.spawn_ranks(_run_rank, n, (entry, argv, n, address,
                                                 torch.get_num_threads()))
            finally:
                shutil.rmtree(folder, ignore_errors=True)
            return None
    return pmesh.init_distributed(a.coordinator_address, a.num_processes, a.process_id,
                                  cpu=a.cpu)


def args_to_config(a: argparse.Namespace) -> TrainConfig:
    # the FPN top-down adds require exact 2x upsample matches: every
    # canonical frame dim must be a multiple of 32 (bucket frames are
    # already validated in _parse_shape_buckets)
    if a.image_height % 32 or a.image_width % 32:
        raise SystemExit(
            f"--image_height/--image_width must be multiples of 32, got "
            f"{a.image_height}x{a.image_width}")
    warmup = WarmupConfig(
        warm_stage=a.warm_stage,
        warm_epoch=tuple(a.warm_epoch),
        warm_layers=tuple(a.warm_layers),
    )
    if a.just_train_classifier:
        # freeze everything except the head outputs for the whole run
        warmup = WarmupConfig(
            warm_stage=1, warm_epoch=(10**6,), warm_layers=("output",)
        )
    return TrainConfig(
        model=ModelConfig(
            depth=a.depth,
            pretrained=(None if str(a.pretrained).lower() in ("none", "false", "")
                        else a.pretrained),
            remat=a.remat,
        ),
        focal=FocalConfig(alpha=a.alpha, gamma=a.gamma),
        data=DataConfig(
            root_dir=a.root_dir,
            dataset=a.dataset,
            batch_size=a.batch_size,
            use_data_ratio=a.use_data_ratio,
            height=a.image_height,
            width=a.image_width,
            # resize targets must fit the canonical frame, else GT clips out
            min_side=a.min_side if a.min_side is not None
            else max(a.image_height - 32, 32),
            max_side=a.max_side if a.max_side is not None else a.image_width,
            train_json=getattr(a, "train_json", None),
            val_json=getattr(a, "test_json", None),
            image_dir_train=getattr(a, "image_dir", None),
            image_dir_val=getattr(a, "image_dir", None),
            shape_buckets=_parse_shape_buckets(
                a.shape_buckets, a.image_height, a.image_width),
            s2d_stem=a.s2d_stem,
            fused_stem=a.fused_stem,
            transfer_dtype=a.transfer_dtype,
        ),
        schedule=ScheduleConfig(
            lr=a.lr,
            scheduler_milestone=tuple(a.scheduler_milestone),
            scheduler_decay=a.scheduler_decay,
            grad_clip=0.0 if a.no_clip else 0.1,
            every_iter=a.every_iter,
            new_state_epoch=a.new_state_epoch,
        ),
        warmup=warmup,
        il=ILConfig(
            scenario=tuple(str(s) for s in a.scenario),
            shuffle_class=a.shuffle_class,
            shuffle_seed=a.seed,
            start_state=a.start_state,
            end_state=a.end_state,
            distill=DistillConfig(enabled=a.distill, logits=a.distill_logits),
            replay=ReplayConfig(
                sample_num=a.sample_num,
                sample_method=a.sample_method,
                prototype_herd_mode=a.prototype_herd_mode,
                sample_batch_size=a.sample_batch_size,
                mix_data=a.mix_data,
                mix_data_start=a.mix_data_start,
                beta_on_replay=a.beta_on_replay,
                beta_on_where=a.beta_on_where,
                enhance_error=a.enhance_error,
                enhance_error_method=a.enhance_error_method,
            ),
            mas=MASConfig(enabled=a.mas, ratio=a.mas_ratio),
            agem=AGEMConfig(enabled=a.agem, refresh_every=a.agem_refresh_every),
            bic=BiCConfig(enabled=a.bic, ratio=a.bic_ratio),
            pseudo=PseudoLabelConfig(enabled=a.persuado_label),
            prototype=PrototypeConfig(loss=a.prototype_loss),
            init_method=a.init_method,
            scail=a.scail,
            classifier_loss=a.classifier_loss,
            ignore_past_class=a.ignore_past_class,
            new_ignore_past_class=a.new_ignore_past_class,
            decrease_positive=a.decrease_positive,
            decrease_positive_by_iou=a.decrease_positive_by_IOU,
            enhance_on_new=a.enhance_on_new,
            ignore_gd=a.ignore_GD,
            clip_loss=a.clip_loss,
            clip_cls_loss=a.clip_cls_loss,
            clip_replay_cls_loss=a.clip_replay_cls_loss,
            final_correction=a.final_correction,
        ),
        mesh=MeshConfig(
            enabled=uses_mesh(a), num_model=a.num_model, num_data=a.num_data,
            zero1=a.zero1,
        ),
        seed=a.seed,
        start_epoch=a.start_epoch,
        end_epoch=a.end_epoch,
        checkpoint_dir=os.path.join(a.root_dir, "checkpoint"),
        record=a.record,
        save_every=a.save_every,
        profile_dir=a.profile,
        description=a.description,
        debug=a.debug,
        val_after_train=a.val,
        output_examplar=a.output_examplar,
        torch_ckpt=getattr(a, "torch_ckpt", None),
        trust_torch_ckpt=getattr(a, "trust_torch_ckpt", False),
    )


def resolve_dataset_paths(a: argparse.Namespace, split: str = "train") -> Tuple[str, str]:
    """(json_path, image_dir) from explicit flags or the root layout
    <root_dir>/<dataset>/{train,test}.json + images/."""
    json_path = a.train_json if split == "train" else a.test_json
    if json_path is None:
        base = os.path.join(a.root_dir, a.dataset)
        json_path = os.path.join(base, f"{split}.json")
    image_dir = a.image_dir or os.path.join(os.path.dirname(json_path), "images")
    return json_path, image_dir


def print_il_info(cfg, states) -> None:
    """Print the IL section of the config + the per-state class table."""
    import dataclasses
    import json as _json

    print("=" * 60)
    for key, value in sorted(dataclasses.asdict(cfg.il).items()):
        print(f"{key} = {_json.dumps(value)}")
    print("-" * 60)
    print(f"Total State number = {len(states)}")
    print(f"Total Class number = {states[len(states) - 1].num_knowing_class}")
    for i in range(len(states)):
        st = states[i]
        print(
            f"State {i}: new({st.num_new_class}) = {st.new_names}, "
            f"knowing = {st.num_knowing_class}"
        )
    print("=" * 60)
