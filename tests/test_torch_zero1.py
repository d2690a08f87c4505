"""ZeRO-1 on the port's data axis (``parallel/mesh.py``, ``train/optim.py``)
against the data axis without it and against JAX, on the CPU.

  * the shard plan: ``zero1_shard`` on every parameter of an R18 and an
    R50 at two and four ranks splits the same axis of the same leaf as
    JAX's ``zero1_extend_spec`` (through the bridge's HWIO -> OIHW order);
  * on two gloo ranks (``tests/torch_mesh_worker.py``; one spawn for
    the two tests that need ranks, computed once per session and shared
    across test workers), two applies of the train step (every_iter 1
    and 2) under ZeRO-1 equal the same ranks' steps without it bit for
    bit: the parameters,
    the gathered moments and the written checkpoint; each rank keeps 1/W
    of the split leaves' moments and the whole of the others'; a ZeRO-1
    checkpoint reloads into ZeRO-1 ranks and into one process;
  * the ranks' ZeRO-1 updates against JAX's ZeRO-1 optimizer on a
    two-device CPU mesh (JAX's tests/test_sharding.py setup at FPN 32 and
    two head layers: R18 float32, 64 x 64 frames, B=8, lr 1e-3) fed the
    ranks' own gradients, at JAX's own parity bar (rtol 2e-5, atol 1e-6):
    this holds the optimizer's sharded update, not the gradients (those
    are held to JAX's in tests/test_torch_mesh_losses.py);
  * ROADMAP §3 item 2, kept for parity: with pseudo-labels on and
    distillation off, the teacher that state 1 builds for them is never
    rebuilt, so the state-0 model pseudo-labels the state-2 images too, in
    the port (three states, one epoch each, on the same two ranks after
    the ZeRO-1 steps, through the sharded pseudo-label pass) and in JAX
    (its trainer driven through the same state transitions).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.parallel import create_mesh
from cl_object_detection_tpu.parallel.mesh import (make_param_constraint, shard_train_state,
                                                   zero1_extend_spec)
from cl_object_detection_tpu.train import trainer as j_trainer_mod
from cl_object_detection_tpu.train.optim import make_optimizer as j_make_optimizer
from cl_object_detection_tpu.train.state import TrainState as JTrainState
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.parallel.mesh import zero1_shard
from cl_object_detection_tpu_torch.train.optim import make_optimizer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import run_ranks, shared_result  # noqa: E402

# one thread, as every test module of the suite sets at import (the last one
# imported sets it for the whole process); the ranks take two
torch.set_num_threads(1)
RANK_THREADS = 2

H, W, C = 64, 64, 4
LR = 1e-3
# R18, FPN 32, 2 head layers, float32 (the two-rank steps and the three-state run)
SMALL = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
SCENARIO = ("2", "2", "1")
# a classification prior of 0.5: the teachers' scores clear the predict
# threshold (0.05) and this one, so there are labels to compare
PRIOR = 0.5
PSEUDO = dict(enabled=True, score_thresh=0.2)


# ------------------------------------------------------------ shard plan

def _jax_leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _jax_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _port_dim(jax_dim: int, ndim: int) -> int:
    """The port's dim of a JAX leaf's dim: a 4-D kernel is HWIO in JAX and
    OIHW in the port (the bridge's transpose (3, 2, 0, 1))."""
    return (3, 2, 0, 1).index(jax_dim) if ndim == 4 else jax_dim


@pytest.mark.parametrize("depth,ndata", [(18, 2), (18, 4), (50, 2), (50, 4)])
def test_zero1_shard_matches_jax_zero1_extend_spec(depth, ndata):
    """Every parameter of a 20-class RetinaNet: ``zero1_shard`` splits the
    leaf JAX's ``zero1_extend_spec`` splits, on the same axis (its port
    dim), in ``ndata`` equal slices one per rank; and leaves JAX keeps
    whole stay whole."""
    num_classes = 20
    model = j_create(jcfg.ModelConfig(depth=depth), num_classes)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    port = dict(create_retinanet(tcfg.ModelConfig(depth=depth), num_classes,
                                 device="cpu").named_parameters())
    seen, split = set(), 0
    for path, leaf in _jax_leaves(shapes["params"]):
        name = port_name(("params",) + path)
        seen.add(name)
        spec = tuple(zero1_extend_spec(P(), leaf.shape, ndata))
        want_dim = _port_dim(spec.index("data"), len(leaf.shape)) if "data" in spec else None
        shape = tuple(port[name].shape)
        for rank in range(ndata):
            got = zero1_shard(shape, ndata, rank)
            if want_dim is None:
                assert got is None, (name, got)
                continue
            size = shape[want_dim] // ndata
            assert got == (want_dim, slice(rank * size, (rank + 1) * size)), (name, got)
        split += want_dim is not None
    assert seen == set(port) and split > len(port) // 2


def test_zero1_output_leaf_follows_the_class_count():
    """The classification output's bias has 9*C rows: 135 (C=15) does not
    divide by two and stays whole, 180 (C=20) splits; its kernel splits on
    the larger input axis either way; one rank splits nothing."""
    assert zero1_shard((135,), 2, 0) is None
    assert zero1_shard((180,), 2, 1) == (0, slice(90, 180))
    assert zero1_shard((135, 256, 3, 3), 2, 1) == (1, slice(128, 256))
    assert zero1_shard((180,), 1, 0) is None
    model = create_retinanet(tcfg.ModelConfig(**SMALL), 3, device="cpu")
    one = make_optimizer(tcfg.ScheduleConfig(), model)
    assert not one.sharded
    assert one.moment_bytes() == 2 * 4 * sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------ two ranks

def _jax_setup():
    """JAX's tests/test_sharding.py ZeRO-1 setup (the model narrowed to
    FPN 32 and two head layers): its variables and the batch."""
    model = j_create(jcfg.ModelConfig(**SMALL), C)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3),
                                                             jnp.zeros((1, H, W, 3))))
    rng = np.random.RandomState(3)
    images = rng.randn(8, H, W, 3).astype(np.float32) * 0.1
    boxes = np.full((8, 4, 4), -1, np.float32)
    labels = np.full((8, 4), -1, np.int32)
    boxes[:, 0] = [12, 12, 44, 44]
    labels[:, 0] = 2
    return variables, (images, boxes, labels)


def _jax_zero1_apply(variables, applied):
    """JAX's ZeRO-1 optimizer on a two-device CPU mesh
    (``shard_train_state(zero1=True)``, the update on the data-split
    moments, ``make_param_constraint`` back to replicated) taking the
    ranks' Adam gradients in turn; the parameters in the port's layout,
    and whether a moment leaf is split over ``data``."""
    mesh = create_mesh(jcfg.MeshConfig(), devices=jax.devices()[:2])
    tx = j_make_optimizer(jcfg.ScheduleConfig(lr=LR, every_iter=1), variables["params"])
    state = shard_train_state(mesh, JTrainState.create(
        params=variables["params"], batch_stats=variables["batch_stats"], tx=tx), zero1=True)
    constrain = make_param_constraint(mesh)

    @jax.jit
    def apply(params, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, params)
        return constrain(jax.tree.map(jnp.add, params, updates)), opt_state

    params, opt_state = state.params, state.opt_state
    for g in applied:
        params, opt_state = apply(params, opt_state, _to_jax(variables["params"], g))
    split = any("data" in str(getattr(x.sharding, "spec", ""))
                for x in jax.tree.leaves(opt_state) if hasattr(x, "sharding") and x.ndim)
    port = create_retinanet(tcfg.ModelConfig(**SMALL), C, device="cpu")
    load_jax_variables(port, {"params": jax.tree.map(np.asarray, params),
                              "batch_stats": variables["batch_stats"]})
    return {k: v.detach().clone() for k, v in port.state_dict().items()}, split


def _to_jax(like, grads):
    """A port gradient dict as a JAX tree shaped like ``like`` (OIHW ->
    HWIO)."""
    def leaf(path, x):
        g = grads[port_name(("params",) + tuple(p.key for p in path))].numpy()
        return jnp.asarray(g.transpose(2, 3, 1, 0) if g.ndim == 4 else g)
    return jax.tree_util.tree_map_with_path(leaf, like)


def _three_state_cfg(root, mesh):
    return tcfg.TrainConfig(
        model=tcfg.ModelConfig(**SMALL, prior=PRIOR),
        data=tcfg.DataConfig(batch_size=2, min_side=100, max_side=192, height=128, width=192,
                             max_boxes=8, num_workers=0, prefetch=0),
        schedule=tcfg.ScheduleConfig(lr=1e-4, every_iter=1, new_state_epoch=1),
        il=tcfg.ILConfig(scenario=SCENARIO, end_state=2, init_method="none",
                         pseudo=tcfg.PseudoLabelConfig(**PSEUDO)),
        mesh=mesh, checkpoint_dir=os.path.join(root, "ck"), start_epoch=1, end_epoch=1,
        record=False)


def _jax_pseudo_teachers(root, json_path, images):
    """JAX's trainer over the three states' transitions (no epochs: the
    teacher's choice does not depend on training): the class count of the
    teacher of every pseudo-label pass, and the state-2 labels' classes."""
    jc = jcfg.TrainConfig.from_json(_three_state_cfg(root, tcfg.MeshConfig()).to_json())
    real = j_trainer_mod.generate_pseudo_labels
    teachers = []

    def spy(model, variables, dataset, *a, **k):
        labels = real(model, variables, dataset, *a, **k)
        teachers.append(dict(classes=int(np.asarray(
            variables["params"]["classification_head"]["output"]["bias"]).size) // 9,
            labels=labels))
        return labels

    j_trainer_mod.generate_pseudo_labels = spy
    try:
        jt = JILTrainer(jc, json_path, images, workdir=root)
        for _ in range(2):
            jt.save(1)
            jt.ckpt.wait()
            jt.next_state()
    finally:
        j_trainer_mod.generate_pseudo_labels = real
    return teachers


def _compute(tmp_path_factory):
    """JAX's variables and batch, and the ranks' ZeRO-1 and data-axis runs
    and their three-state run (``case_zero1``, one spawn); the tests run
    their JAX sides themselves, so a test worker waits only for this."""
    variables, batch = _jax_setup()
    port = create_retinanet(tcfg.ModelConfig(**SMALL), C, device="cpu")
    load_jax_variables(port, variables)
    work = str(tmp_path_factory.mktemp("zero1_ranks"))
    toy = os.path.join(work, "toy")
    json_path = make_toy_dataset(toy, num_images=12, seed=7, image_size=(48, 64))
    images = os.path.join(toy, "images")
    root = os.path.join(work, "il")
    pseudo = dict(cfg=_three_state_cfg(root, tcfg.MeshConfig(enabled=True)), json=json_path,
                  images=images, workdir=root)
    args = dict(model_cfg=tcfg.ModelConfig(**SMALL), num_classes=C, lr=LR,
                state_dict=port.state_dict(), batch=batch, anchors=anchors_for_shape(H, W),
                pseudo_teachers=pseudo)
    ranks = _on_ranks(os.path.join(work, "w"), "zero1", args)
    return dict(ranks=ranks, variables=variables, batch=batch, json=json_path, images=images)


@pytest.fixture(scope="module")
def zero1(tmp_path_factory):
    return shared_result(tmp_path_factory, "zero1", lambda: _compute(tmp_path_factory))


def _on_ranks(workdir, case, args):
    """``run_ranks`` with two torch threads for the ranks (the module sets
    one, as every module of the suite: the last one imported sets it for
    the whole process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        return run_ranks(workdir, case, args, timeout=600)
    finally:
        torch.set_num_threads(threads)


def test_zero1_on_two_ranks_equals_the_data_axis_and_jax(zero1):
    """On two ranks, two applies at every_iter 1 and 2: ZeRO-1's
    parameters, gathered moments and rank 0's checkpoint equal the data
    axis's, bit for bit, on both ranks (both ranks' parameters alike); only
    the split leaves' moments shrink (1/W of the leaf on each rank); a
    ZeRO-1 optimizer that reloads the checkpoint keeps its slices and
    gathers the same state; the checkpoint (every_iter 1) loads into one
    process, which takes a finite step from it; and the parameters after
    two steps (every_iter 1) hold to JAX's ZeRO-1 optimizer on a two-device
    CPU mesh (its moments split over ``data``) taking the same gradients,
    at JAX's parity bar. (The gradients are held to JAX's in
    tests/test_torch_mesh_losses.py: after Adam, which divides each element
    by its own magnitude, the elements whose gradient is near Adam's eps
    move by their frameworks' rounding, a few of them past this bar when
    JAX computes its own gradients.) One test: the checks share one spawn."""
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step

    for every_iter in (1, 2):
        ranks = [r[every_iter] for r in zero1["ranks"]]
        assert ranks[0]["checksums"] == ranks[1]["checksums"], every_iter
        for r in ranks:
            assert r["sharded"] == (True, False)
            assert r["params_equal"] and r["optimizer_equal"] and r["reloaded"], every_iter
            whole, mine = r["moment_numel"]["dp"], r["moment_numel"]["zero1"]
            assert all(mine[n] in (whole[n], whole[n] // 2) for n in whole)
            assert len([n for n in whole if mine[n] * 2 == whole[n]]) > len(whole) // 2
            assert r["moment_bytes"] == {t: 4 * sum(v.values())
                                         for t, v in r["moment_numel"].items()}
        assert ranks[0]["checkpoint_equal"], every_iter

    r0 = zero1["ranks"][0][1]
    ck = torch.load(os.path.join(r0["root"], "4", "state0", "epoch1", "state.pt"),
                    weights_only=True)
    model = create_retinanet(tcfg.ModelConfig(**SMALL), C, device="cpu")
    model.load_state_dict(ck["model"])
    opt = make_optimizer(tcfg.ScheduleConfig(lr=LR), model)
    opt.load_state_dict(ck["optimizer"])
    sd = opt.state_dict()
    assert sd["param_groups"] == ck["optimizer"]["param_groups"]
    assert all(torch.equal(sd["state"][i][k], v) for i, st in ck["optimizer"]["state"].items()
               for k, v in st.items())
    step = make_train_step(model, None, anchors_for_shape(H, W), ILConfig(), FocalConfig(),
                           LossStatics(num_classes=C), StepStatics(every_iter=1))
    _, m = step(TrainState(model, opt, step=int(ck["step"])),
                *(torch.from_numpy(a) for a in zero1["batch"]))
    assert np.isfinite(float(m["total_loss"]))
    assert opt.param_groups[0]["count"] == ck["optimizer"]["param_groups"][0]["count"] + 1

    jax_params, jax_split = _jax_zero1_apply(zero1["variables"], r0["applied"])
    assert jax_split and len(r0["applied"]) == 2
    got, want = r0["params"], jax_params
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=2e-5, atol=1e-6, err_msg=k)


def test_pseudo_label_teacher_stays_the_state0_model(zero1, tmp_path):
    """ROADMAP §3 item 2, kept for parity: with pseudo-labels on and
    distillation off, the state-1 and the state-2 pseudo-labels both come
    from the state-0 model (2 classes) in the port on two ranks (three
    states, one epoch each, through the sharded pseudo-label pass) and in
    JAX, so the state-2 labels hold state-0 classes only, none of state
    1's; the ranks agree on every label and trained three states."""
    r0, r1 = (r["pseudo_teachers"] for r in zero1["ranks"])
    assert r0["epochs"] == [(0, 1), (1, 1), (2, 1)]
    assert r0["checksums"] == r1["checksums"]
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.states import ILStates

    coco = CocoJson(zero1["json"])
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, list(SCENARIO))
    state0 = set(states[0].new_ids)
    jax_teachers = _jax_pseudo_teachers(str(tmp_path / "jax"), zero1["json"], zero1["images"])
    for teachers in (r0["teachers"], jax_teachers):
        assert [t["classes"] for t in teachers] == [2, 2]
        cats = {a["category_id"] for anns in teachers[1]["labels"].values() for a in anns}
        assert cats and cats <= state0, cats
    assert [t["labels"] for t in r0["teachers"]] == [t["labels"] for t in r1["teachers"]]
