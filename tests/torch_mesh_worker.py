"""One rank of the port's mesh, for the tests/test_torch_mesh*.py,
test_torch_zero1.py and test_torch_model_axis.py files.

    python tests/torch_mesh_worker.py RANK WORLD WORKDIR

Joins a gloo group of WORLD CPU ranks through a ``file://`` store in
WORKDIR, builds the mesh that ``WORKDIR/job.pt`` names (the data axis
alone unless it gives ``MeshConfig`` fields), runs the case it names
with its arguments, and writes what the case returns to
``WORKDIR/out<RANK>.pt``. It imports torch and the port only (no JAX),
so a rank starts in a few seconds.
``run_ranks`` starts the ranks and joins each with a timeout.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(workdir: str, case: str, args: dict, world: int = 2, timeout: float = 240.0,
              mesh: dict = None):
    """Run ``case`` on ``world`` ranks in fresh processes, each with the
    caller's number of torch threads (the CPU kernels' results may depend
    on it, and the tests compare the ranks with the caller), on the mesh
    of ``MeshConfig(enabled=True, **mesh)``; returns each rank's result. A
    rank that fails, or any rank still running after ``timeout`` seconds,
    fails the caller (every rank is killed)."""
    import torch

    os.makedirs(workdir, exist_ok=True)
    threads = torch.get_num_threads()
    torch.save({"case": case, "args": args, "threads": threads, "mesh": mesh or {}},
               os.path.join(workdir, "job.pt"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS=str(threads))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               workdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{case}: a rank was still running after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case}: rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def shared_result(tmp_path_factory, name: str, compute, timeout: float = 900.0):
    """``compute()`` once per test session, whichever test workers ask
    (pytest-xdist runs a module fixture again on every worker that runs a
    test using it): the first caller computes and saves the result in the
    session's temporary root, the others wait for it and load it. A
    failed computation fails every caller."""
    import torch

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                      # shared by the session's workers
    path, lock = root / f"{name}.result.pt", root / f"{name}.lock"
    try:
        os.close(os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        deadline = time.monotonic() + timeout
        while not path.exists():
            if time.monotonic() > deadline:
                raise AssertionError(f"{name}: no result after {timeout} s")
            time.sleep(0.5)
        out = torch.load(str(path), weights_only=False)
        if isinstance(out, dict) and "__error__" in out:
            raise AssertionError(f"{name} failed in another worker: {out['__error__']}")
        return out
    tmp = root / f"{name}.partial.pt"
    try:
        out = compute()
    except BaseException as e:
        torch.save({"__error__": repr(e)}, str(tmp))
        os.replace(str(tmp), str(path))
        raise
    torch.save(out, str(tmp))
    os.replace(str(tmp), str(path))
    return out


@contextlib.contextmanager
def float64_plain_path(model):
    """``model`` and the loss in float64: the parameters, buffers and every
    module's compute dtype, and ``Tensor.float`` (the loss's casts to
    float32) leaving a float64 tensor as it is."""
    import torch

    model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    real = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else real(t, *a, **k)
    try:
        yield model
    finally:
        torch.Tensor.float = real


# ----------------------------------------------------------------------
# cases: fn(mesh, args, workdir) -> a picklable result
# ----------------------------------------------------------------------

def _model(cfg, num_classes, state_dict):
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    model = create_retinanet(cfg, num_classes, device="cpu")
    model.load_state_dict(state_dict)
    return model


def loss_grads(a, frames, mesh=None):
    """Each loss configuration of ``a["frames"][frames]`` (images, boxes,
    labels, anchors, cases) on this rank's slice of the batch (the whole
    batch without ``mesh``): {case: (all-reduced gradient of the total,
    global metrics)}."""
    import torch

    from cl_object_detection_tpu_torch.config import FocalConfig
    from cl_object_detection_tpu_torch.il.losses import compute_losses
    from cl_object_detection_tpu_torch.parallel.mesh import all_reduce_grads, all_reduce_metrics

    f = a["frames"][frames]
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    per = f["images"].shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    batch = [torch.from_numpy(f[k][sl]) for k in ("images", "boxes", "labels")]
    teacher = _model(a["model_cfg"], a["c_old"], a["teacher"]).requires_grad_(False)
    out = {}
    for name, il_cfg, statics in f["cases"]:
        model = _model(a["model_cfg"], statics.num_classes, a["student"])
        kw = {}
        if statics.incremental:
            kw.update(teacher=teacher, classifier_vectors=a["class_vectors"],
                      prototype_features=a["prototypes"])
        if statics.use_mas:
            kw.update(mas_prev_params=a["mas_prev"], mas_importance=a["mas_importance"])
        total, metrics = compute_losses(model, *batch, torch.from_numpy(f["anchors"]), il_cfg,
                                        FocalConfig(), statics, mesh=mesh, **kw)
        total.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in model.named_parameters()}
        grads = all_reduce_grads(mesh, grads)
        metrics = all_reduce_metrics(mesh, metrics)
        out[name] = ({k: v.numpy() for k, v in grads.items()},
                     {k: float(v.detach()) for k, v in metrics.items()})
    return out


def case_losses(mesh, a, workdir):
    """``loss_grads`` at every frame size of ``a["frames"]``."""
    return {frames: loss_grads(a, frames, mesh) for frames in a["frames"]}


def _trainer_record(tr):
    from cl_object_detection_tpu_torch.parallel.mesh import module_checksums

    return dict(
        params={k: v.detach().clone() for k, v in tr.model.state_dict().items()},
        checksums=module_checksums(tr.model),
        loss_hist=list(tr.loss_hist),
        epochs=[(r["state"], r["epoch"]) for r in tr.epoch_log],
        exemplars=list(tr.dataset_replay.image_ids) if tr.dataset_replay is not None else None,
        bic=None if tr.bic is None else (tr.bic.params.alphas.tolist(),
                                         tr.bic.params.betas.tolist()),
        mas_keys=None if tr.mas_importance is None else sorted(tr.mas_importance),
        replay_grad=None if tr.agem is None or tr.agem.replay_grad is None else
        {k: v.clone() for k, v in tr.agem.replay_grad.items()},
        cur_state=tr.cur_state,
        files=sorted(os.path.relpath(os.path.join(d, f), tr.ckpt.root)
                     for d, _, fs in os.walk(tr.ckpt.root) for f in fs),
    )


def case_train(mesh, a, workdir):
    """``train_process`` of ``a["cfg"]`` on this rank; with ``a["expect"]``
    the trainer's construction must raise that error instead."""
    from cl_object_detection_tpu_torch.train.loop import train_process
    from cl_object_detection_tpu_torch.train.trainer import ILTrainer

    try:
        tr = ILTrainer(a["cfg"], a["json"], a["images"], workdir=a["workdir"], device="cpu")
    except ValueError as e:
        if a.get("expect"):
            return {"error": str(e)}
        raise
    assert not a.get("expect"), "the trainer did not raise"
    train_process(tr)
    return _trainer_record(tr)


def case_distill_step(mesh, a, workdir):
    """JAX's test_mesh_incremental_distill_step on the ranks: state 0 in
    the classifier warm stage with accumulation, two micro-steps and a
    save, then state 1 from that checkpoint with distillation, two
    micro-steps; the metrics of each and the parameters after."""
    from cl_object_detection_tpu_torch.parallel.mesh import check_replicas
    from cl_object_detection_tpu_torch.train.trainer import ILTrainer

    tr0 = ILTrainer(a["cfg0"], a["json"], a["images"], workdir=a["workdir"], device="cpu")
    tr0.cur_epoch = tr0.end_epoch = 1
    tr0.warm_up(1)
    batch = next(iter(tr0.train_loader))
    m0 = [tr0.run_batch(batch), tr0.run_batch(batch)]
    tr0.save(1)
    tr0.ckpt.wait()
    tr1 = ILTrainer(a["cfg1"], a["json"], a["images"], workdir=a["workdir"], device="cpu")
    tr1.cur_epoch = tr1.end_epoch = 1
    batch = next(iter(tr1.train_loader))
    m1 = [tr1.run_batch(batch), tr1.run_batch(batch)]
    return dict(warm=tr0._warm_kind, m0=m0, m1=m1, teacher=tr1.teacher_model is not None,
                sums=check_replicas(mesh, tr1.model),
                params={k: v.detach().clone() for k, v in tr1.model.state_dict().items()})


def anchors_for(images):
    from cl_object_detection_tpu_torch.data.transforms import logical_image_hw
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    return anchors_for_shape(*logical_image_hw(images))


def case_tools(mesh, a, workdir):
    """Each IL tool pass with ``mesh=`` (None: one process) on the old
    model of scenario 3+2: the similarity and the pseudo-labels over the
    state-1 images, the MAS importance, herding, the prototypes and
    prototype-herd over the state-0 images; and the number of batches of
    each image set this rank ran."""
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.data.dataset import ILDataset
    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    from cl_object_detection_tpu_torch.il.herding import HerdSampler
    from cl_object_detection_tpu_torch.il.mas import compute_importance
    from cl_object_detection_tpu_torch.il.prototype import (compute_prototype_features,
                                                            prototype_herd_scores,
                                                            prototype_herd_slot_scores)
    from cl_object_detection_tpu_torch.il.pseudo_label import generate_pseudo_labels
    from cl_object_detection_tpu_torch.il.weight_init import compute_similarity

    from cl_object_detection_tpu_torch.states import ILStates

    coco = CocoJson(a["json"])
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["3", "2"])
    old, new = (ILDataset(coco, states, a["images"], split="train", start_state=s)
                for s in (0, 1))
    model = _model(a["model_cfg"], 3, a["state_dict"])
    cfg = a["data_cfg"]
    unaugmented = lambda ds: BatchLoader(ds, cfg, shuffle=False, augment=False)
    herd = HerdSampler(a["herd_ratio"])
    out = dict(
        similarity=compute_similarity(model, anchors_for, unaugmented(new), 2, 3, mesh=mesh),
        importance={k: v.numpy() for k, v in compute_importance(
            model, anchors_for, unaugmented(old), mesh=mesh).items()},
        herd=herd.sample(model, old, cfg, 2, mesh=mesh),
        prototypes=compute_prototype_features(model, anchors_for, unaugmented(old), 3,
                                              mesh=mesh),
        pseudo=generate_pseudo_labels(model, new, cfg, a["pseudo_cfg"],
                                      states.inverse_label_map(), mesh=mesh),
    )
    out["herd_list"] = list(herd.examplar_list)
    out["proto_slots"] = prototype_herd_slot_scores(model, anchors_for, old, cfg,
                                                    out["prototypes"], mesh=mesh)
    out["proto_mean"] = prototype_herd_scores(model, anchors_for, old, cfg, out["prototypes"],
                                              mesh=mesh)
    # this rank's share of each pass's batches (all of them in one process)
    from cl_object_detection_tpu_torch.parallel.mesh import pass_loader

    out["batches"] = {name: len(pass_loader(mesh, unaugmented(ds)))
                      for name, ds in (("old", old), ("new", new))}
    return out


def case_validate(mesh, a, workdir):
    """``cli.validate.run_validation`` of ``a["argv"]`` on the ranks, the
    model's config given ``a["model"]``'s fields; the results every rank
    returns."""
    import functools

    from cl_object_detection_tpu_torch import config
    from cl_object_detection_tpu_torch.cli import common, validate

    common.ModelConfig = functools.partial(config.ModelConfig, **a["model"])
    a_ns = validate.get_parser().parse_args(a["argv"])
    results = validate.run_validation(a_ns, device="cpu")
    return {e: (r.mean_ap50, dict(r.ap50)) for e, r in results.items()}


def case_collectives(mesh, a, workdir):
    """The helpers of parallel/mesh.py on this rank's values."""
    import torch

    from cl_object_detection_tpu_torch.parallel import mesh as pm

    r = mesh.rank
    grads = {"a": torch.full((3, 2), float(r + 1)), "b": torch.arange(4.0) * (r + 1)}
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r))
    pm.broadcast_module(mesh, lin)
    parted = torch.nn.Linear(3, 2)
    with torch.no_grad():
        parted.weight.fill_(float(r))
    try:
        pm.check_replicas(mesh, parted, "probe")
        parted_raised = False
    except RuntimeError:
        parted_raised = True
    return dict(
        grads={k: v.numpy() for k, v in pm.all_reduce_grads(mesh, grads).items()},
        metrics={k: float(v) for k, v in pm.all_reduce_metrics(
            mesh, {"x": torch.tensor(float(r)), "y": torch.tensor(2.0 * r)}).items()},
        count=float(pm.all_reduce_sum(mesh, torch.tensor(float(r + 1)))),
        obj=pm.broadcast_object(mesh, {"rank": r}),
        gathered=pm.all_gather_object(mesh, r),
        weight=lin.weight.detach().numpy().copy(),
        sums=pm.check_replicas(mesh, lin),
        parted_raised=parted_raised,
        shape=mesh.shape, backend=mesh.backend, rank=mesh.rank,
    )


def _trees_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def zero1_steps(mesh, a, every_iter, workdir):
    """Two applies of the train step (``every_iter`` micro-steps each) on
    this rank's half of ``a["batch"]`` from ``a["state_dict"]``, on the
    data axis and then under ZeRO-1 (the same ranks): whether ZeRO-1's
    parameters, whole optimizer state and checkpoint equal the data axis's
    bit for bit, whether a ZeRO-1 optimizer that reloads the checkpoint
    gathers the same state, each run's moment sizes on this rank, and the
    ZeRO-1 parameters' checksums (on rank 0 at every_iter 1, the
    parameters, the gradient each Adam step took and the checkpoint's
    directory, kept for the caller; the other checkpoints are removed)."""
    import dataclasses
    import shutil

    import torch

    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig, ScheduleConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.parallel.mesh import barrier, module_checksums
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step
    from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager

    images, boxes, labels = (torch.from_numpy(x) for x in a["batch"])
    per = images.shape[0] // mesh.world
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    runs = {}
    for tag, m in (("dp", dataclasses.replace(mesh, zero1=False)),
                   ("zero1", dataclasses.replace(mesh, zero1=True))):
        model = _model(a["model_cfg"], a["num_classes"], a["state_dict"])
        opt = make_optimizer(ScheduleConfig(lr=a["lr"], every_iter=every_iter), model, m)
        step = make_train_step(model, None, a["anchors"], ILConfig(), FocalConfig(),
                               LossStatics(num_classes=a["num_classes"]),
                               StepStatics(every_iter=every_iter), mesh=m)
        state = TrainState(model, opt)
        applied = []
        real_step = opt.step

        def step_and_record():
            # the gradient Adam takes: all-reduced, clipped, whole
            applied.append({n: p.grad.clone() for n, p in model.named_parameters()})
            real_step()

        opt.step = step_and_record
        for _ in range(2 * every_iter):
            state, _ = step(state, images[sl], boxes[sl], labels[sl])
        root = os.path.join(workdir, f"ck_{tag}_{every_iter}")
        CheckpointManager(root, ["4"], mesh=m).save(0, 1, model, opt, state.step)
        ckpt = torch.load(os.path.join(root, "4", "state0", "epoch1", "state.pt"),
                          weights_only=True)
        fresh = make_optimizer(ScheduleConfig(lr=a["lr"]), model, m)
        fresh.load_state_dict(ckpt["optimizer"])
        runs[tag] = dict(model=model, opt=opt, whole=opt.state_dict(), root=root, ckpt=ckpt,
                         reloaded=_trees_equal(fresh.state_dict(), ckpt["optimizer"]),
                         applied=applied)
    dp, z = runs["dp"], runs["zero1"]
    out = dict(
        params_equal=_trees_equal(z["model"].state_dict(), dp["model"].state_dict()),
        optimizer_equal=_trees_equal(z["whole"], dp["whole"]),
        checkpoint_equal=_trees_equal(z["ckpt"], dp["ckpt"]),
        reloaded=z["reloaded"] and dp["reloaded"],
        sharded=(z["opt"].sharded, dp["opt"].sharded),
        checksums=module_checksums(z["model"]),
        moment_bytes={t: r["opt"].moment_bytes() for t, r in runs.items()},
        moment_numel={t: {n: sum(v.numel() for v in r["opt"].state[p].values())
                          for n, p in r["model"].named_parameters()}
                      for t, r in runs.items()})
    barrier(mesh)
    keep = mesh.rank == 0 and every_iter == 1
    if keep:
        out.update(params={k: v.detach().clone() for k, v in z["model"].state_dict().items()},
                   root=z["root"], applied=z["applied"])
    if mesh.rank == 0:
        for tag, r in runs.items():
            if not (keep and tag == "zero1"):
                shutil.rmtree(r["root"], ignore_errors=True)
    return out


def case_zero1(mesh, a, workdir):
    """ZeRO-1's steps for every_iter 1 and 2 (``zero1_steps``), then
    ``pseudo_teachers`` of ``a["pseudo_teachers"]`` (one spawn for both)."""
    out = {e: zero1_steps(mesh, a, e, workdir) for e in (1, 2)}
    out["pseudo_teachers"] = pseudo_teachers(mesh, a["pseudo_teachers"], workdir)
    return out


def pseudo_teachers(mesh, a, workdir):
    """``case_train``'s record of ``a``'s run, plus, for each pseudo-label
    pass, its teacher's class count and the labels."""
    from cl_object_detection_tpu_torch.train import trainer as trainer_mod

    teachers = []
    real = trainer_mod.generate_pseudo_labels

    def spy(model, dataset, *args, **kw):
        labels = real(model, dataset, *args, **kw)
        teachers.append(dict(classes=model.classification_head.output.bias.numel() // 9,
                             labels=labels))
        return labels

    trainer_mod.generate_pseudo_labels = spy
    try:
        out = case_train(mesh, a, workdir)
    finally:
        trainer_mod.generate_pseudo_labels = real
    out["teachers"] = teachers
    return out


# ----------------------------------------------------------------------
# the model axis (tests/test_torch_model_axis.py)
# ----------------------------------------------------------------------

def _data_slice(mesh, batch):
    """This rank's data index's slice of every array of ``batch`` (the
    whole batch without a data axis)."""
    n = batch[0].shape[0]
    parts = mesh.num_data if mesh is not None else 1
    index = mesh.data_index if mesh is not None else 0
    per = n // parts
    return [x[index * per:(index + 1) * per] for x in batch]


def _worst(got, want) -> float:
    """max |got - want| / max |want| (|got - want| for an all-zero ``want``)."""
    top = float(want.abs().max())
    return float((got - want).abs().max()) / top if top else float((got - want).abs().max())


def _model_group_counts():
    """(calls of the model group's trunk collectives, gradient gathers)
    since the counters were last reset (the mesh spans' counters)."""
    from cl_object_detection_tpu_torch.utils import profiling

    c, none = profiling.counters(), profiling.Count(0, 0)
    calls = (c.get("cldet.mesh.model_all_reduce", none).calls
             + c.get("cldet.mesh.model_all_gather", none).calls)
    return calls, c.get("cldet.mesh.gather_model_grads", none).calls


def model_axis_heads(mesh, a):
    """The split head trunks against the whole ones on this rank, at each
    trunk depth of ``a["head_layers"]``: one forward (both heads, five
    levels) and backward of a sum of squares of the outputs, first whole,
    then inside ``head_parallel`` with the slices' gradients joined
    (``gather_model_grads``); per depth, the worst ``_worst`` of the
    outputs, of the heads' parameter gradients and of the rest, and the
    model group's collectives of the split pass."""
    import torch

    from cl_object_detection_tpu_torch.config import ModelConfig
    from cl_object_detection_tpu_torch.models.heads import head_parallel
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.parallel import mesh as pm
    from cl_object_detection_tpu_torch.utils import profiling

    images = torch.from_numpy(a["images"])
    out = {}
    for layers in a["head_layers"]:
        model = create_retinanet(ModelConfig(**dict(a["model"], head_layers=layers)), 3,
                                 device="cpu", generator=torch.Generator().manual_seed(layers))
        with torch.no_grad():
            for h in (model.regression_head, model.classification_head):
                h.output.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(7))
        runs = []
        for split in (None, mesh):
            model.zero_grad(set_to_none=True)
            profiling.reset_counters()
            with head_parallel(model, split):
                cls, reg = model(images, enable_act=False)
            (cls.square().sum() + reg.square().sum()).backward()
            calls, _ = _model_group_counts()
            grads = pm.gather_model_grads(split, {n: p.grad for n, p in
                                                  model.named_parameters()})
            runs.append((cls.detach(), reg.detach(), grads, calls))
        (c0, r0, g0, _), (c1, r1, g1, calls) = runs
        heads = [n for n in g0 if pm.head_tp_kind(n) is not None]
        out[layers] = dict(
            outputs=max(_worst(c1, c0), _worst(r1, r0)),
            trunk_grads=max(_worst(g1[n], g0[n]) for n in heads),
            other_grads=max(_worst(g1[n], g0[n]) for n in g0 if n not in heads),
            calls=calls, trunk_leaves=len(heads))
    return out


def model_axis_steps(mesh, a):
    """On ``mesh`` (None: one process), from ``a``'s weights and batch:
    (state 0) one train-step micro-step of the plain loss, every_iter 1,
    no clip; (state 1) one micro-step with distillation, the classifier
    similarity and MAS terms and the A-GEM projection against the negated
    replay gradient of the same batch (computed on the same mesh by
    ``AGem``), every_iter 1, clip on. Per step the gradient Adam took, the
    metrics, the model group's collectives and gradient gathers of the
    micro-step, and the Adam moments this rank keeps per leaf; the
    replay gradient."""
    import torch

    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig, ScheduleConfig
    from cl_object_detection_tpu_torch.data.loader import Batch
    from cl_object_detection_tpu_torch.il.agem import AGem
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step
    from cl_object_detection_tpu_torch.utils import profiling

    images, boxes, labels = (torch.from_numpy(x) for x in _data_slice(mesh, a["batch"]))
    c, c_old = a["num_classes"], a["c_old"]
    il_cfg = ILConfig()

    def run(model, statics, step_statics, **kw):
        opt = make_optimizer(ScheduleConfig(lr=a["lr"]), model, mesh)
        step = make_train_step(model, kw.pop("teacher", None), a["anchors"], il_cfg,
                               FocalConfig(), statics, step_statics, mesh=mesh)
        applied = {}
        real = opt.step

        def record():
            applied.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
            real()

        opt.step = record
        profiling.reset_counters()
        _, metrics = step(TrainState(model, opt), images, boxes, labels, **kw)
        calls, gathers = _model_group_counts()
        return dict(applied={k: v.numpy() for k, v in applied.items()},
                    metrics={k: float(v) for k, v in metrics.items()},
                    calls=calls, gathers=gathers,
                    moments={n: sum(v.numel() for v in opt.state[p].values())
                             for n, p in model.named_parameters()})

    out = {"state0": run(_model(a["model_cfg"], c, a["student0"]),
                         LossStatics(num_classes=c),
                         StepStatics(every_iter=1, use_clip=False))}
    model = _model(a["model_cfg"], c, a["student"])
    teacher = _model(a["model_cfg"], c_old, a["teacher"]).requires_grad_(False)
    n = images.shape[0]
    replay = Batch(images=images.numpy(), boxes=boxes.numpy(), labels=labels.numpy(),
                   num_boxes=(labels.numpy() >= 0).sum(1).astype("int32"),
                   num_pseudo=torch.zeros(n, dtype=torch.int32).numpy(),
                   scales=torch.ones(n).numpy(), image_ids=torch.arange(n).numpy())
    agem = AGem(model, a["anchors"], il_cfg, FocalConfig(),
                LossStatics(num_classes=c, num_past_class=c_old, is_replay=True), [replay],
                mesh=mesh)
    replay_grad = {k: -v for k, v in agem.compute_replay_grad().items()}
    out["state1"] = run(
        model,
        LossStatics(num_classes=c, num_past_class=c_old, incremental=True, use_distill=True,
                    use_classifier_loss=True, use_mas=True),
        StepStatics(every_iter=1, use_agem=True, num_past_class=c_old, num_knowing_class=c),
        teacher=teacher, replay_grad=replay_grad, classifier_vectors=a["class_vectors"],
        mas_prev_params=a["mas_prev"], mas_importance=a["mas_importance"])
    out["replay_grad"] = {k: v.numpy() for k, v in replay_grad.items()}
    return out


def case_model_axis_1x2(mesh, a, workdir):
    """``model_axis_heads`` and ``model_axis_steps`` on a 1 x 2 mesh; rank
    1 returns checksums of its gradients in place of the gradients."""
    import zlib

    out = dict(heads=model_axis_heads(mesh, a), steps=model_axis_steps(mesh, a),
               shape=mesh.shape, index=(mesh.data_index, mesh.model_index))
    if mesh.rank:
        for key in ("state0", "state1"):
            st = out["steps"][key]
            st["applied"] = {k: zlib.crc32(v.tobytes()) for k, v in st["applied"].items()}
        out["steps"]["replay_grad"] = {k: zlib.crc32(v.tobytes())
                                       for k, v in out["steps"]["replay_grad"].items()}
    return out


def case_model_axis_2x2(mesh, a, workdir):
    """``cli.train`` of ``a["argv"]`` on the ranks (the model's config
    given ``a["model"]``'s fields, its initial weights ``a["init"]``) into
    ``a["root"]``, then the same under ``--zero1 true`` into
    ``a["root_zero1"]``, then ``cli.validate`` of ``a["validate"]`` on the
    first run's checkpoint. Per run: this rank's place, whether it is
    sharded, its Adam moments per leaf, its checksums and global losses,
    rank 0's parameters; whether the two runs' checkpoints (model, whole
    moments, groups, step) are equal bit for bit; the validation's
    mAP50."""
    import functools

    import torch

    from cl_object_detection_tpu_torch import config
    from cl_object_detection_tpu_torch.cli import common, validate
    from cl_object_detection_tpu_torch.cli.train import main as train_main
    from cl_object_detection_tpu_torch.parallel.mesh import barrier, module_checksums
    from cl_object_detection_tpu_torch.train import trainer as trainer_mod

    common.ModelConfig = functools.partial(config.ModelConfig, **a["model"])
    real_create = trainer_mod.create_retinanet

    def create(*args, **kw):
        model = real_create(*args, **kw)
        model.load_state_dict(a["init"])
        return model

    trainer_mod.create_retinanet = create
    proc = ["--coordinator_address", f"file://{os.path.join(workdir, 'store')}",
            "--num_processes", str(mesh.world), "--process_id", str(mesh.rank)]
    out = {}
    for tag, root, extra in (("plain", a["root"], []),
                             ("zero1", a["root_zero1"], ["--zero1", "true"])):
        tr = train_main(a["argv"] + ["--root_dir", root] + extra + proc)
        out[tag] = dict(
            shape=tr.mesh.shape, index=(tr.mesh.data_index, tr.mesh.model_index),
            zero1=tr.mesh.zero1, sharded=tr.optimizer.sharded,
            moments={n: sum(v.numel() for v in tr.optimizer.state[p].values())
                     for n, p in tr.model.named_parameters()},
            checksums=module_checksums(tr.model), loss_hist=list(tr.loss_hist),
            epochs=[(r["state"], r["epoch"]) for r in tr.epoch_log])
        if mesh.rank == 0:
            out[tag]["params"] = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        del tr
    barrier(mesh)
    if mesh.rank == 0:
        trees = [torch.load(os.path.join(r, "checkpoint", "5", "state0", "epoch1", "state.pt"),
                            weights_only=True) for r in (a["root"], a["root_zero1"])]
        out["checkpoints_equal"] = _trees_equal(*trees)
        out["moment_tensors"] = sum(len(v) for v in trees[0]["optimizer"]["state"].values())
    a_ns = validate.get_parser().parse_args(a["validate"] + proc)
    results = validate.run_validation(a_ns, device="cpu")
    out["map50"] = {e: r.mean_ap50 for e, r in results.items()}
    return out


CASES = {k[5:]: v for k, v in dict(globals()).items() if k.startswith("case_")}


def main() -> int:
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch

    from cl_object_detection_tpu_torch.config import MeshConfig
    from cl_object_detection_tpu_torch.parallel import mesh as pm

    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    pm.init_distributed(num_processes=world, process_id=rank, cpu=True,
                        init_method=f"file://{os.path.join(workdir, 'store')}")
    torch.set_num_threads(job["threads"])
    mesh = pm.create_mesh(MeshConfig(enabled=True, **job["mesh"]), torch.device("cpu"))
    result = CASES[job["case"]](mesh, job["args"], workdir)
    torch.save(result, os.path.join(workdir, f"out{rank}.pt"))
    pm.barrier(mesh)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
