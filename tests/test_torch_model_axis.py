"""The mesh's model axis (``parallel/mesh.py``, ``models/heads.py``)
against JAX and against one process, on the CPU.

  * The rule, no ranks: ``head_tp_shard`` splits exactly the leaves and
    dims of an R18 (20 classes) that JAX's ``head_tp_spec`` splits, and
    ``zero1_shard`` with that split as its base the ones that JAX's
    ``zero1_extend_spec`` adds (through the bridge's names and its HWIO ->
    OIHW order), with JAX's own examples of tests/test_sharding.py.
  * One 1 x 2 spawn (two gloo ranks, ``tests/torch_mesh_worker.py``; one
    worker call, shared by its three tests across test workers): the split
    head trunks at depths 4 and 3 against the whole ones, forward and
    backward, within float32 rounding (|d| <= 1e-5 of the tensor's
    largest), with 2 x 2 heads x 5 levels collectives forward and as many
    backward at depth 4; one train-step micro-step's gradient (R18, FPN
    32, four head layers, float32, 128 x 128, B=4) against JAX's
    ``value_and_grad`` of ``compute_losses``, run eagerly, and against the
    port's one process, both at the gradient bar (|d| <= 1e-3 |g| + 1e-4
    max|g| of the leaf); a state-1 micro-step with distillation, the
    classifier-similarity and MAS terms and the A-GEM projection (the
    replay gradient computed on the ranks too) against one process at the
    same bar; each rank keeps half of each trunk leaf's moments.
  * One 2 x 2 spawn (four gloo ranks): ``cli.train --mesh true --num_data 2
    --num_model 2`` of state 0 configured as JAX's
    tests/test_mesh_train.py::test_dp4_tp2_runs_and_matches (R18, float32,
    128 x 192 frames, B=8, every_iter 2, one epoch, 16 toy images), from
    JAX's initial weights, whose parameters hold to JAX's trainer on its
    4 x 2 mesh at JAX's own bar (rtol 2e-3, atol 2e-5); the same run under
    ``--zero1 true`` bit for bit (checkpoint with whole moments, checksums,
    losses), each rank keeping a quarter of a trunk weight's moments; and
    ``cli.validate --mesh`` of its checkpoint on the same ranks, whose rows
    equal one process's bit for bit.
"""
import argparse
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.il import losses as jlosses
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.models.expand import expand_classifier as j_expand
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.parallel.mesh import head_tp_spec, zero1_extend_spec
from cl_object_detection_tpu.train.loop import train_process as j_train_process
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.cli import common, validate
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.models.expand import classifier_class_vectors
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.parallel import mesh as pm
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mesh_losses import make_batch, mas_trees, np_tree, randomize, to_port  # noqa: E402
from torch_mesh_worker import model_axis_steps, run_ranks, shared_result  # noqa: E402

torch.set_num_threads(1)

# (b): R18, FPN 32, four head layers (conv1-conv4: column, row, column, row)
CFG = dict(depth=18, fpn_channels=32, head_layers=4, compute_dtype="float32")
C_OLD, C_NEW = 3, 2
C = C_OLD + C_NEW
H = W = 128
LR = 1e-4
SIM = np.array([[0.6, 0.3, 0.1], [0.2, 0.5, 0.3]], np.float32)


def _bad(got, want):
    """Elements past the gradient bar: |d| > 1e-3 |want| + 1e-4 max|want|."""
    return np.abs(got - want) > 1e-3 * np.abs(want) + 1e-4 * np.abs(want).max()


def assert_at_gradient_bar(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        bad = _bad(got[k], w)
        assert not bad.any(), (f"{what} {k}: {int(bad.sum())} of {w.size} beyond the bar, "
                               f"max |d| {np.abs(got[k] - w).max():.3g}, "
                               f"max |g| {np.abs(w).max():.3g}")


# ------------------------------------------------------------------ (a)

def _jax_params_with_paths(depth, num_classes=20):
    model = j_create(jcfg.ModelConfig(depth=depth), num_classes)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jax.tree_util.tree_flatten_with_path(shapes["params"])[0]


def _port_dim(jax_dim: int, ndim: int) -> int:
    """The port's dim of a JAX leaf's dim (the bridge's HWIO -> OIHW)."""
    return (3, 2, 0, 1).index(jax_dim) if ndim == 4 else jax_dim


@pytest.mark.parametrize("num_model,ndata", [(2, 2), (2, 4), (4, 2)])
def test_head_tp_and_zero1_shards_match_jax_specs(num_model, ndata):
    """Every parameter of a 20-class R18: ``head_tp_shard`` splits the
    leaves ``head_tp_spec`` puts on ``model``, on the same dim, in
    ``num_model`` equal slices; ``zero1_shard`` given that split adds the
    dim ``zero1_extend_spec`` puts ``data`` on; ``shard_plans`` gives each
    rank of the ``ndata x num_model`` grid both slices; the other leaves
    stay whole."""
    port = {n: tuple(p.shape) for n, p in create_retinanet(
        tcfg.ModelConfig(depth=18), 20, device="cpu").named_parameters()}
    mesh = pm.DataMesh(rank=0, world=ndata * num_model, device=torch.device("cpu"),
                       zero1=True, num_model=num_model)
    named = [(n, torch.empty(s, device="meta")) for n, s in port.items()]
    plans = pm.shard_plans(mesh, named)
    seen, tp = set(), 0
    for path, leaf in _jax_params_with_paths(18):
        name = port_name(("params",) + tuple(str(p.key) for p in path))
        seen.add(name)
        shape, nd = port[name], len(leaf.shape)
        base_spec = head_tp_spec(path, leaf)
        spec = tuple(zero1_extend_spec(base_spec, leaf.shape, ndata))
        base_spec = tuple(base_spec) + (None,) * (nd - len(tuple(base_spec)))
        want_m = _port_dim(base_spec.index("model"), nd) if "model" in base_spec else None
        want_d = _port_dim(spec.index("data"), nd) if "data" in spec else None
        tp += want_m is not None
        for r in range(ndata * num_model):
            d, m = divmod(r, num_model)
            base = pm.head_tp_shard(name, shape, num_model, m)
            data = pm.zero1_shard(shape, ndata, d, base)
            for got, want, k, count in ((base, want_m, m, num_model), (data, want_d, d, ndata)):
                if want is None:
                    assert got is None, (name, got)
                else:
                    size = shape[want] // count
                    assert got == (want, slice(k * size, (k + 1) * size)), (name, got)
            assert plans[r][name] == (tuple(s for s in (base, data) if s is not None) or None)
    assert seen == set(port)
    # the trunks' four convs of both heads: weight and bias of conv1/conv3, weight of conv2/4
    assert tp == 2 * (2 * 2 + 2)


def test_jax_sharding_examples_and_the_channel_check():
    """tests/test_sharding.py's examples: a column-parallel kernel (HWIO
    (3, 3, 256, 128), ``model`` on its output) gains ``data`` on its input
    at ndata 4, in the port's OIHW (128, 256, 3, 3) dim 1; a leaf with no
    free dim that divides stays put. Channels that the model axis does not
    divide raise (GSPMD would pad them)."""
    assert zero1_extend_spec(P(None, None, None, "model"), (3, 3, 256, 128),
                             ndata=4) == P(None, None, "data", "model")
    base = pm.head_tp_shard("classification_head.conv1.weight", (128, 256, 3, 3), 2, 1)
    assert base == (0, slice(64, 128))
    assert [pm.zero1_shard((128, 256, 3, 3), 4, d, base) for d in range(4)] == [
        (1, slice(64 * d, 64 * (d + 1))) for d in range(4)]
    assert zero1_extend_spec(P(), (7,), ndata=4) == P()
    assert pm.zero1_shard((7,), 4, 0, None) is None
    assert pm.head_tp_shard("regression_head.conv2.bias", (256,), 2, 1) is None
    assert pm.head_tp_shard("fpn.p3_lateral.weight", (256, 128, 1, 1), 2, 1) is None
    with pytest.raises(ValueError, match="fpn_channels must divide"):
        pm.head_tp_shard("regression_head.conv1.weight", (30, 30, 3, 3), 4, 0)


# ------------------------------------------------------------------ (b)

@functools.lru_cache(maxsize=None)
def jax_model(num_classes, seed, cls_bias=-1.5):
    model = j_create(jcfg.ModelConfig(**CFG), num_classes)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    return model, np_tree(randomize(v, 100 + seed, cls_bias))


def port_state(variables, num_classes) -> dict:
    model = create_retinanet(tcfg.ModelConfig(**CFG), num_classes, device="cpu")
    load_jax_variables(model, variables)
    return {k: v.clone() for k, v in model.state_dict().items()}


def jax_plain_grad(variables, batch):
    """JAX's eager ``value_and_grad`` of the plain ``compute_losses`` of
    the whole batch, as port-named numpy gradients."""
    model, _ = jax_model(C, 1)

    def loss_fn(params, images, boxes, labels):
        return jlosses.compute_losses(
            lambda vv, x, act: model.apply(vv, x, enable_act=act),
            lambda vv, x, act: model.apply(vv, x, enable_act=act, method="forward_all"),
            {"params": params, "batch_stats": variables["batch_stats"]},
            images, boxes, labels, jnp.asarray(anchors_for_shape(H, W)), jcfg.ILConfig(),
            jcfg.FocalConfig(), jlosses.LossStatics(num_classes=C))

    with jax.disable_jit():
        (_, m), g = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"], *(jnp.asarray(a) for a in batch))
    return {k: float(v) for k, v in m.items()}, to_port(g)


def _compute_1x2(tmp_path_factory):
    _, s0 = jax_model(C, 1)
    _, tv = jax_model(C_OLD, 0)
    sv = jax.tree.map(lambda x: x, s0)
    sv["params"]["classification_head"]["output"] = np_tree(
        j_expand(tv["params"], C_NEW, similarity=SIM)["classification_head"]["output"])
    batch = make_batch(7)
    mas = mas_trees(sv["params"], 9)
    teacher = port_state(tv, C_OLD)
    args = dict(
        model=CFG, head_layers=(4, 3), images=batch[0][:2],
        model_cfg=tcfg.ModelConfig(**CFG), num_classes=C, c_old=C_OLD, lr=LR,
        batch=batch, anchors=anchors_for_shape(H, W), student0=port_state(s0, C),
        student=port_state(sv, C), teacher=teacher,
        class_vectors=torch.from_numpy(classifier_class_vectors(teacher)),
        mas_prev={k: torch.from_numpy(v) for k, v in to_port(mas[0]).items()},
        mas_importance={k: torch.from_numpy(v) for k, v in to_port(mas[1]).items()})
    ranks = run_ranks(str(tmp_path_factory.mktemp("model_axis_1x2")), "model_axis_1x2", args,
                      timeout=600, mesh=dict(num_model=2))
    return dict(ranks=ranks, one=model_axis_steps(None, args))


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory):
    return shared_result(tmp_path_factory, "model_axis_1x2",
                         lambda: _compute_1x2(tmp_path_factory))


def test_split_head_trunks_equal_the_whole_ones(one_by_two):
    """On both ranks of the 1 x 2 mesh, at trunk depths 4 and 3 (where the
    last conv is column-parallel and its output is joined): the outputs
    and every gradient within float32 rounding of the whole trunks'; 2
    collectives per head and level forward (depth 4: *g* after conv2 and
    conv4; depth 3: *g* and the join) and 2 backward (*f* before conv1
    and conv3)."""
    for r in one_by_two["ranks"]:
        assert r["shape"] == {"data": 1, "model": 2}
        for layers, h in r["heads"].items():
            assert max(h["outputs"], h["trunk_grads"], h["other_grads"]) <= 1e-5, (layers, h)
            assert h["trunk_leaves"] == 2 * 2 * layers
        # per head and level, depth 4: g twice forward, f twice backward; depth 3:
        # g and the join of conv3's slices forward, f twice backward
        assert r["heads"][4]["calls"] == r["heads"][3]["calls"] == 2 * (2 * 2 * 5)
    assert [r["index"] for r in one_by_two["ranks"]] == [(0, 0), (0, 1)]


def test_split_train_step_gradient_matches_jax_and_one_process(one_by_two):
    """State 0: the whole gradient Adam took on the 1 x 2 mesh (the
    trunks' slices joined) at the gradient bar against JAX's eager
    ``value_and_grad`` of the whole batch and against the port's one
    process; the same bits on both ranks; the global loss terms at rtol
    1e-4 of JAX's; 40 collectives and one gradient gather in the
    micro-step; each rank keeps half of every trunk leaf's moments."""
    ranks, one = one_by_two["ranks"], one_by_two["one"]
    r0 = ranks[0]["steps"]["state0"]
    jm, jg = jax_plain_grad(jax_model(C, 1)[1], make_batch(7))
    assert_at_gradient_bar(r0["applied"], jg, "against JAX")
    assert_at_gradient_bar(r0["applied"], one["state0"]["applied"], "against one process")
    for k in ("cls_fg_loss", "cls_bg_loss", "reg_loss", "total_loss"):
        np.testing.assert_allclose(r0["metrics"][k], jm[k], rtol=1e-4, err_msg=k)
    import zlib

    crc = {k: zlib.crc32(v.tobytes()) for k, v in r0["applied"].items()}
    assert ranks[1]["steps"]["state0"]["applied"] == crc
    for r in ranks:
        st = r["steps"]["state0"]
        assert (st["calls"], st["gathers"]) == (40, 1)
        whole = one["state0"]["moments"]
        for n, k in st["moments"].items():
            assert k == (whole[n] // 2 if pm.head_tp_kind(n) and not (
                n.endswith("bias") and pm.head_tp_kind(n) == "row") else whole[n]), n


def test_split_state1_step_with_battery_matches_one_process(one_by_two):
    """State 1 on the 1 x 2 mesh: the replay gradient (A-GEM, through the
    split trunks) and the projected, clipped gradient of a micro-step with
    distillation, the similarity and MAS terms at the gradient bar against
    one process's; the projection engaged (the projected gradient is
    orthogonal to the replay gradient); the same bits on both ranks."""
    ranks, one = one_by_two["ranks"], one_by_two["one"]
    r0 = ranks[0]["steps"]
    assert_at_gradient_bar(r0["replay_grad"], one["replay_grad"], "replay gradient")
    assert_at_gradient_bar(r0["state1"]["applied"], one["state1"]["applied"], "state 1")
    for k in ("dist_feat_loss", "dist_cls_loss", "dist_reg_loss", "sim_loss", "mas_loss"):
        assert k in r0["state1"]["metrics"], k
        np.testing.assert_allclose(r0["state1"]["metrics"][k], one["state1"]["metrics"][k],
                                   rtol=1e-4, err_msg=k)
    g, rg = one["state1"]["applied"], one["replay_grad"]
    dot = sum(float(np.sum(g[k].astype(np.float64) * rg[k])) for k in g)
    norms = np.sqrt(sum(float(np.sum(np.square(g[k], dtype=np.float64))) for k in g)
                    * sum(float(np.sum(np.square(rg[k], dtype=np.float64))) for k in g))
    assert abs(dot) <= 1e-4 * norms
    import zlib

    assert ranks[1]["steps"]["state1"]["applied"] == {
        k: zlib.crc32(v.tobytes()) for k, v in r0["state1"]["applied"].items()}
    assert ranks[1]["steps"]["state1"]["calls"] == r0["state1"]["calls"] == 40


# ------------------------------------------------------------------ (c)

TP_FLAGS = ["--scenario", "5", "--depth", "18", "--image_height", "128", "--image_width",
            "192", "--min_side", "100", "--max_side", "192", "--batch_size", "8", "--lr",
            "1e-4", "--every_iter", "2", "--end_epoch", "1", "--record", "false",
            "--print_il_info", "false", "--cpu", "--mesh", "true", "--num_data", "2",
            "--num_model", "2"]
FLOAT32 = dict(compute_dtype="float32")


def _port_config(argv, root):
    """The port's TrainConfig of ``cli.train`` flags, in float32."""
    parser = argparse.ArgumentParser()
    common.add_train_flags(parser)
    real = common.ModelConfig
    common.ModelConfig = functools.partial(tcfg.ModelConfig, **FLOAT32)
    try:
        return common.args_to_config(parser.parse_args(argv + ["--root_dir", root]))
    finally:
        common.ModelConfig = real


def _jax_trainer(port_cfg, data, workdir):
    """JAX's trainer of the same config (through its params.json text) on
    its 4 x 2 mesh of the 8 CPU devices."""
    jc = jcfg.TrainConfig.from_json(port_cfg.to_json()).replace(
        mesh=jcfg.MeshConfig(enabled=True, num_model=2),
        checkpoint_dir=os.path.join(workdir, "ckpt"))
    return JILTrainer(jc, os.path.join(data, "train.json"), os.path.join(data, "images"),
                      workdir=workdir)


def _compute_2x2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("model_axis_2x2"))
    data = os.path.join(root, "toy")
    make_toy_dataset(data, num_images=16, seed=3, split="train")
    make_toy_dataset(data, num_images=8, seed=4, split="test")
    argv = ["--train_json", os.path.join(data, "train.json"), "--image_dir",
            os.path.join(data, "images")] + TP_FLAGS
    port_cfg = _port_config(argv, root)
    # the ranks start from the weights JAX's trainer starts from
    jt = _jax_trainer(port_cfg, data, os.path.join(root, "jax_init"))
    init = create_retinanet(port_cfg.model, 5, device="cpu")
    load_jax_variables(init, jax.tree.map(np.asarray, jt.train_state.variables))
    del jt
    vflags = (["--test_json", os.path.join(data, "test.json"), "--image_dir",
               os.path.join(data, "images"), "--epoch", "1", "--threshold", "0.001"]
              + TP_FLAGS[:-7] + ["--cpu"])
    run = os.path.join(root, "tp")
    args = dict(argv=argv, model=FLOAT32, init=init.state_dict(), root=run,
                root_zero1=os.path.join(root, "tp_zero1"),
                validate=["--root_dir", run] + vflags + TP_FLAGS[-6:])
    ranks = run_ranks(os.path.join(root, "w"), "model_axis_2x2", args, world=4, timeout=900,
                      mesh=dict(num_model=2))
    # one process's cli.validate of the same checkpoint in batches of 4, the
    # ranks' (the same images in the same slots); the ranks' rows: rank 0's file
    real = common.ModelConfig
    common.ModelConfig = functools.partial(tcfg.ModelConfig, **FLOAT32)
    try:
        one = validate.main(["--root_dir", run] + vflags + [
            "--batch_size", "4", "--new_folder", "true", "--specific_folder", "one"])
    finally:
        common.ModelConfig = real
    out = os.path.join(run, "val_result", "5", "state0")
    rows = {}
    for tag in ("", "one"):
        with open(os.path.join(out, tag, "voc2007_results_epoch1.json")) as f:
            rows[tag] = json.load(f)
    return dict(ranks=ranks, rows=rows, one_map50=one[1].mean_ap50, root=root, argv=argv)


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    return shared_result(tmp_path_factory, "model_axis_2x2",
                         lambda: _compute_2x2(tmp_path_factory), timeout=1200.0)


def test_two_by_two_cli_train_matches_jax_4x2_trainer(two_by_two):
    """``cli.train`` on a 2 x 2 mesh (four ranks: data index r // 2, model
    index r % 2) from JAX's initial weights: rank 0's parameters within
    rtol 2e-3, atol 2e-5 of JAX's trainer on its 4 x 2 mesh (whose head
    kernels carry ``model``); every rank's parameters bit-identical;
    the global losses at rtol 1e-4 of JAX's."""
    ranks = two_by_two["ranks"]
    root = two_by_two["root"]
    jt = _jax_trainer(_port_config(two_by_two["argv"], root), os.path.join(root, "toy"),
                      os.path.join(root, "jax"))
    j_train_process(jt)
    spec = jt.train_state.params["classification_head"]["conv1"]["kernel"].sharding.spec
    assert tuple(spec)[-1] == "model"
    assert [r["plain"]["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["plain"]["shape"] == {"data": 2, "model": 2} for r in ranks)
    assert all(r["plain"]["checksums"] == ranks[0]["plain"]["checksums"] for r in ranks)
    assert all(r["plain"]["loss_hist"] == ranks[0]["plain"]["loss_hist"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["plain"]["loss_hist"], list(jt.loss_hist), rtol=1e-4)
    got = ranks[0]["plain"]["params"]
    want = to_port(jax.tree.map(np.asarray, jt.train_state.params))
    assert set(want) <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-3, atol=2e-5, err_msg=k)


def test_two_by_two_zero1_is_bit_for_bit_the_mesh_without_it(two_by_two):
    """The same run under ``--zero1 true``: its checkpoint (parameters,
    whole Adam moments, groups, step), checksums and losses equal the run
    without it bit for bit; each rank keeps half of every trunk leaf's
    moments without ZeRO-1 and a quarter of a trunk weight's with it."""
    ranks = two_by_two["ranks"]
    assert ranks[0]["checkpoints_equal"] and ranks[0]["moment_tensors"] > 0
    for r in ranks:
        plain, z = r["plain"], r["zero1"]
        assert (plain["zero1"], plain["sharded"], z["zero1"], z["sharded"]) == (
            False, True, True, True)
        assert z["checksums"] == plain["checksums"] and z["loss_hist"] == plain["loss_hist"]
        for n in ("classification_head.conv1.weight", "regression_head.conv4.weight"):
            whole = 256 * 256 * 9 * 2
            assert (plain["moments"][n], z["moments"][n]) == (whole // 2, whole // 4), n
        out = "classification_head.output.weight"              # (45, 256, 3, 3), replicated
        assert (plain["moments"][out], z["moments"][out]) == (2 * 45 * 256 * 9, 45 * 256 * 9)


def test_two_by_two_cli_validate_equals_one_process(two_by_two):
    """``cli.validate --mesh true --num_data 2 --num_model 2`` on the 2 x 2
    run's checkpoint: the batch (8) split over the data axis only, model
    index 0's rows gathered; its rows equal bit for bit one process's in
    batches of 4 (each rank's share: the same images in the same slots)."""
    rows = two_by_two["rows"]
    assert rows[""] and rows[""] == rows["one"]
    for r in two_by_two["ranks"]:
        assert r["map50"][1] == two_by_two["one_map50"]
