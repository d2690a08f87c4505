"""The port's MAS and A-GEM against the JAX package's, in float32 on the
CPU: ``il/mas.py`` (``importance_mask``, ``compute_importance``),
``il/losses.mas_penalty`` and the ``mas_loss`` term of
``compute_losses``, ``il/agem.py`` (``bn_mask``,
``AGem.compute_replay_grad``), the train step's projection, and the
trainer's MAS and A-GEM from state 0 into state 1 (``_update_mas``,
``_update_mas_for_next``, ``_init_agem``, the loop's refresh). Weights
cross from JAX through ``models.bridge``.

Models: R18, FPN 32, 2 head layers; 3 old + 2 new classes. The unit
tests run 64 x 96 RGB frames; the trainer runs the 96 x 96 PNG toy set
at 128 x 128 frames (scale 1, so both packages' loaders give the same
batches).

Tolerances:
  * masks: equal, leaf for leaf, through the bridge's name map;
  * gradients and the importance (a mean of |grad|) at the train step's
    bar (tests/test_torch_train_step.py): |d| <= 1e-3 |g_jax| + 1e-4
    max|g_jax| per leaf. The importance and the replay gradient are held
    to JAX's own functions run eagerly (``jax.disable_jit``): jitted,
    XLA's compile of the importance step moves the backbone's gradients
    by up to 5e-4 of the leaf's largest from a float64 evaluation, where
    JAX's eager run and the port stay within 1e-6 of it (the watch-list's
    "gradient oracles");
  * losses and the MAS penalty at rtol 1e-4;
  * the trainer: every micro-step's total_loss at rtol 1e-4, lr 1e-5
    (tests/test_torch_trainer.py's bars); the ``mas_importance`` sidecar
    at the gradient bar.
"""
import dataclasses
import functools
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.il import agem as jagem
from cl_object_detection_tpu.il import losses as jlosses
from cl_object_detection_tpu.il import mas as jmas
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.train.loop import train_process as j_train_process
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.il import agem, losses as tlosses, mas
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.train import step as tstep
from cl_object_detection_tpu_torch.train.loop import train_process
from cl_object_detection_tpu_torch.train.optim import make_optimizer
from cl_object_detection_tpu_torch.train.state import TrainState
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

torch.set_num_threads(1)

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
C_OLD, C_NEW = 3, 2
C = C_OLD + C_NEW
H, W = 64, 96
ANCHORS = anchors_for_shape(H, W)
LR = 1e-5


# ----------------------------------------------------------------- helpers

def randomize(variables, seed):
    """Random BN statistics and affines; random output convs with logits
    of std ~1 around the prior (no saturated sigmoid)."""
    r = np.random.RandomState(seed)

    def leaf(path, x):
        keys = tuple(p.key for p in path)
        x = np.asarray(x)
        if keys[-2:-1] == ("bn",):
            if keys[-1] == "mean":
                return (r.randn(*x.shape) * 0.1).astype(np.float32)
            if keys[-1] == "var":
                return (np.abs(r.randn(*x.shape)) * 0.2 + 0.8).astype(np.float32)
            if keys[-1] == "scale":
                return (1 + r.randn(*x.shape) * 0.1).astype(np.float32)
            return (r.randn(*x.shape) * 0.05).astype(np.float32)
        if "output" in keys:
            if keys[-1] == "kernel":
                return (r.randn(*x.shape) * 0.0015).astype(np.float32)
            return (x + r.randn(*x.shape) * 0.05).astype(np.float32)
        return x

    return jax.tree.map(lambda x: np.array(x, np.float32),
                        jax.tree_util.tree_map_with_path(leaf, variables))


@functools.lru_cache(maxsize=None)
def jax_model(num_classes, seed=0):
    model = j_create(jcfg.ModelConfig(**CFG), num_classes)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    return model, randomize(v, 100 + seed)


def port_model(variables, num_classes):
    model = create_retinanet(tcfg.ModelConfig(**CFG), num_classes, device="cpu")
    load_jax_variables(model, variables)
    return model


def to_port(params) -> dict:
    """A JAX ``params``-shaped tree as {port name: float32 numpy, OIHW}."""
    out = {}
    for path, val in jax.tree_util.tree_leaves_with_path(params):
        arr = np.asarray(val, np.float32)
        name = port_name(("params",) + tuple(p.key for p in path))
        out[name] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return out


def port_values(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def assert_grads_close(got: dict, want: dict, what="grad"):
    """|d| <= 1e-3 |g_jax| + 1e-4 max|g_jax|, leaf by leaf."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for name, w in want.items():
        bad = np.abs(got[name] - w) > 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()
        assert not bad.any(), (f"{what} {name}: {int(bad.sum())} of {w.size} beyond "
                               f"tolerance, max |d| {np.abs(got[name] - w).max():.3g}, "
                               f"max |g| {np.abs(w).max():.3g}")


def make_batch(seed, num_classes=C, n=2):
    """RGB frames and 1-3 boxes per image of labels below ``num_classes``."""
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    x = ((img.astype(np.float32) / 255.0 - 0.45) / 0.225).astype(np.float32)
    boxes = np.full((n, 5, 4), -1, np.float32)
    labels = np.full((n, 5), -1, np.int32)
    for b in range(n):
        for j in range(1 + b % 3):
            x1, y1 = r.uniform(0, 50), r.uniform(0, 25)
            boxes[b, j] = [x1, y1, x1 + r.uniform(20, 45), y1 + r.uniform(20, 38)]
            labels[b, j] = r.randint(0, num_classes)
    return SimpleNamespace(images=x, boxes=boxes, labels=labels)


class ListLoader(list):
    """A loader over fixed batches (what the tools iterate and ``len``)."""


def targs(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (batch.images, batch.boxes, batch.labels))


def jargs(batch):
    return tuple(jnp.asarray(a) for a in (batch.images, batch.boxes, batch.labels))


# ------------------------------------------------------------------ masks

def test_importance_mask_and_bn_mask_equal_jax():
    """Both masks equal JAX's leaf for leaf through the bridge's names:
    the stem's ``bn1``, every ``bn*`` leaf out of both; ``downsample_bn``
    in both; ``classification_head.output`` out of MAS's only."""
    _, v = jax_model(C)
    params = dict(port_model(v, C).named_parameters())
    got_mas, got_bn = port_values(mas.importance_mask(params)), port_values(agem.bn_mask(params))
    want_mas = to_port(jmas.importance_mask(v["params"]))
    want_bn = to_port(jagem.bn_mask(v["params"]))
    for got, want in ((got_mas, want_mas), (got_bn, want_bn)):
        assert set(got) == set(want) == set(params)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("backbone.bn1.weight", "backbone.bn1.bias", "backbone.layer1_0.bn2.weight",
                 "backbone.layer4_1.bn1.bias"):
        assert not got_mas[name].any() and not got_bn[name].any(), name
    for name in ("backbone.layer2_0.downsample_bn.weight",
                 "backbone.layer3_0.downsample_bn.bias"):
        assert got_mas[name].all() and got_bn[name].all(), name
    for name in ("classification_head.output.weight", "classification_head.output.bias"):
        assert not got_mas[name].any() and got_bn[name].all(), name
    assert got_mas["classification_head.conv1.weight"].all()
    assert got_mas["backbone.conv1.weight"].all() and got_bn["fpn.p7.bias"].all()


# -------------------------------------------------------------------- MAS

def test_compute_importance_matches_jax():
    """Two batches: the mean |grad| of the output norm per leaf at the
    gradient bar against JAX's importance run eagerly, and within 1e-5 of
    the leaf's largest of the port's own float64 evaluation; zero on
    every excluded leaf, nonzero elsewhere."""
    model, v = jax_model(C)
    loader = ListLoader([make_batch(1), make_batch(2)])
    with jax.disable_jit():
        want = to_port(jmas.compute_importance(model, v, ANCHORS, loader))
    got = port_values(mas.compute_importance(port_model(v, C), ANCHORS, loader))
    assert_grads_close(got, want, "importance")
    step = mas.make_importance_step(port_model(v, C).double())
    exact = None
    for b in loader:
        g = step(*(torch.tensor(a, dtype=torch.float64 if a.dtype == np.float32 else None)
                   for a in (ANCHORS, b.images, b.boxes, b.labels)))
        exact = g if exact is None else {k: exact[k] + g[k] for k in g}
    for k, e in exact.items():
        e = (e / 2).numpy() * mas.importance_mask({k: e})[k].numpy()
        assert np.abs(got[k] - e).max() <= 1e-5 * np.abs(e).max(), k
    for name, arr in got.items():
        assert np.isfinite(arr).all() and arr.dtype == np.float32
        assert (arr.any() == (not mas._excluded(name))), name


def test_compute_importance_mesh_raises(monkeypatch):
    """The mesh (ROADMAP §1 item 6a, once refused here; its passes split
    over the ranks since item 6b-i): on a one-rank mesh the importance is
    one process's; on rank 1 of two, whose share of a one-batch loader
    (batch i on rank i mod 2) is empty, the ranks' sums and the global
    batch count come through all-reduces (stubbed here: every element 1,
    the count 1), so its importance is the mask."""
    from cl_object_detection_tpu_torch.parallel import mesh as pm

    _, v = jax_model(C)
    loader = ListLoader([make_batch(1)])
    want = mas.compute_importance(port_model(v, C), ANCHORS, loader)
    one = pm.DataMesh(rank=0, world=1, device=torch.device("cpu"))
    got = mas.compute_importance(port_model(v, C), ANCHORS, loader, mesh=one)
    assert all(torch.equal(got[k], want[k]) for k in want)
    monkeypatch.setattr(pm.dist, "all_reduce", lambda t, *a, **k: t.fill_(1.0))
    rank1 = pm.DataMesh(rank=1, world=2, device=torch.device("cpu"), backend="gloo")
    model = port_model(v, C)
    got = mas.compute_importance(model, ANCHORS, loader, mesh=rank1)
    mask = mas.importance_mask(dict(model.named_parameters()))
    assert set(got) == set(want) and all(torch.equal(got[k], mask[k]) for k in got)


def test_mas_penalty_and_mask_mirror_jax():
    """JAX's tests/test_il_methods.py cases: BN and the classification
    output excluded, downsample BN kept; penalty ratio * sum(2 * 1^2) over
    the kept leaf; a leaf whose shape differs from the previous one (the
    expanded classifier) contributes 0."""
    params = {"backbone.w": torch.ones(3), "backbone.bn1.weight": torch.ones(3),
              "classification_head.output.weight": torch.ones(2),
              "backbone.layer2_0.downsample_bn.weight": torch.ones(2)}
    mask = mas.importance_mask(params)
    assert float(mask["backbone.bn1.weight"].sum()) == 0
    assert float(mask["classification_head.output.weight"].sum()) == 0
    assert float(mask["backbone.w"].sum()) == 3
    assert float(mask["backbone.layer2_0.downsample_bn.weight"].sum()) == 2
    prev = {k: v * 0.0 for k, v in params.items()}
    imp = {k: m * 2.0 for k, m in mask.items()}
    del params["backbone.layer2_0.downsample_bn.weight"]
    assert float(tlosses.mas_penalty(params, prev, imp, ratio=0.5)) == pytest.approx(3.0)
    assert float(tlosses.mas_penalty({"out": torch.ones(4)}, {"out": torch.ones(2)},
                                     {"out": torch.ones(4)}, 1.0)) == 0.0


def _penalty_inputs(seed):
    """A params tree, its previous values (the classifier output at the
    old width) and an importance tree, as JAX trees and port dicts."""
    _, v = jax_model(C)
    _, v_old = jax_model(C_OLD)
    r = np.random.RandomState(seed)
    params = v["params"]
    prev = jax.tree.map(lambda x: (x + r.randn(*x.shape) * 0.01).astype(np.float32),
                        v_old["params"])
    imp = jax.tree.map(lambda x: np.abs(r.randn(*x.shape)).astype(np.float32), params)
    return params, prev, imp


def test_mas_penalty_value_and_grad_match_jax():
    """The value and its gradient at the bar against jax.value_and_grad;
    the expanded classification output contributes 0 and gets no
    gradient."""
    params, prev, imp = _penalty_inputs(3)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlosses.mas_penalty(p, prev, imp, 0.7)))(params)
    tp = {k: torch.from_numpy(a).requires_grad_(True) for k, a in to_port(params).items()}
    got = tlosses.mas_penalty(tp, {k: torch.from_numpy(a) for k, a in to_port(prev).items()},
                              {k: torch.from_numpy(a) for k, a in to_port(imp).items()}, 0.7)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    grads = {k: t.grad.numpy() if t.grad is not None else np.zeros(t.shape, np.float32)
             for k, t in tp.items()}
    assert_grads_close(grads, to_port(want_g))
    assert tp["classification_head.output.weight"].grad is None


@pytest.mark.parametrize("path", ["plain", "incremental"])
def test_compute_losses_with_mas_matches_jax(path):
    """``use_mas`` on the plain and the incremental path: every metric,
    ``mas_loss`` among them, at rtol 1e-4, and the gradient of
    ``mas_loss`` at the bar against JAX's jitted value_and_grad."""
    model, v = jax_model(C)
    _, prev, imp = _penalty_inputs(4)
    batch = make_batch(5)
    incremental = path == "incremental"
    statics = dict(num_classes=C, num_past_class=C_OLD if incremental else 0,
                   incremental=incremental, use_mas=True)
    il = dataclasses.replace(jcfg.ILConfig(), mas=jcfg.MASConfig(enabled=True, ratio=0.5))

    def loss_fn(p):
        _, m = jlosses.compute_losses(
            lambda vv, xx, act: model.apply(vv, xx, enable_act=act),
            lambda vv, xx, act: model.apply(vv, xx, enable_act=act, method="forward_all"),
            {"params": p, "batch_stats": v["batch_stats"]}, *jargs(batch),
            jnp.asarray(ANCHORS), il, jcfg.FocalConfig(), jlosses.LossStatics(**statics),
            mas_prev_params=prev, mas_importance=imp)
        return m["mas_loss"], m

    (_, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    pm = port_model(v, C)
    _, metrics = tlosses.compute_losses(
        pm, *targs(batch), torch.from_numpy(ANCHORS),
        tcfg.ILConfig(mas=tcfg.MASConfig(enabled=True, ratio=0.5)), tcfg.FocalConfig(),
        tlosses.LossStatics(**statics),
        mas_prev_params={k: torch.from_numpy(a) for k, a in to_port(prev).items()},
        mas_importance={k: torch.from_numpy(a) for k, a in to_port(imp).items()})
    assert set(metrics) == set(jm) and "mas_loss" in metrics
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    metrics["mas_loss"].backward()
    got = {n: p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
           for n, p in pm.named_parameters()}
    assert_grads_close(got, to_port(jgrads))


# ------------------------------------------------------------------ A-GEM

def test_agem_replay_grad_matches_jax():
    """Two replay batches whose gradients exceed the 0.1 clip: the average
    of the clipped, BN-masked gradients at the bar against JAX's AGem run
    eagerly, the BN leaves zero, the downsample BN's not."""
    model, v = jax_model(C)
    loader = ListLoader([make_batch(6), make_batch(7)])
    statics = dict(num_classes=C, num_past_class=C_OLD, incremental=False, is_replay=True)
    ja = jagem.AGem(model, ANCHORS, jcfg.ILConfig(), jcfg.FocalConfig(),
                    jlosses.LossStatics(**statics), loader)
    with jax.disable_jit():
        want = to_port(ja.compute_replay_grad(v))
    pm = port_model(v, C)
    pa = agem.AGem(pm, ANCHORS, tcfg.ILConfig(), tcfg.FocalConfig(),
                   tlosses.LossStatics(**statics), loader)
    got = port_values(pa.compute_replay_grad())
    assert_grads_close(got, want, "replay grad")
    assert pa.replay_grad is not None and set(pa.replay_grad) == set(dict(pm.named_parameters()))
    # the clip acted: each batch's raw gradient is above 0.1 in norm
    for batch in loader:
        total, _ = tlosses.compute_losses(pm, *targs(batch), torch.from_numpy(ANCHORS),
                                          tcfg.ILConfig(), tcfg.FocalConfig(),
                                          tlosses.LossStatics(**statics))
        g = torch.autograd.grad(total, list(pm.parameters()))
        assert float(torch.sqrt(sum(torch.sum(x * x) for x in g))) > 0.1
    assert not got["backbone.bn1.weight"].any() and not got["backbone.layer1_0.bn1.bias"].any()
    assert got["backbone.layer2_0.downsample_bn.weight"].any()
    assert all(p.grad is None for p in pm.parameters())   # the accumulator untouched


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_train_step_projects_against_the_replay_grad(sign):
    """The step with ``use_agem``: against a replay gradient whose
    inner product with the step's gradient is well below 0, the applied
    gradient is g - (<g, g_r> / ||g_r||^2) g_r (orthogonal to g_r); well
    above 0, it is g unchanged."""
    _, v = jax_model(C)
    batch = targs(make_batch(8))
    probe = port_model(v, C)
    total, _ = tlosses.compute_losses(probe, *batch, torch.from_numpy(ANCHORS),
                                      tcfg.ILConfig(), tcfg.FocalConfig(),
                                      tlosses.LossStatics(num_classes=C))
    names, params = zip(*probe.named_parameters())
    g = dict(zip(names, torch.autograd.grad(total, params)))
    r = np.random.RandomState(9)
    replay = {k: sign * x + 0.3 * torch.from_numpy(r.randn(*x.shape).astype(np.float32))
              * x.abs().max() for k, x in g.items()}
    dot = sum(float(torch.sum(g[k].double() * replay[k].double())) for k in g)
    assert dot * sign > 0 and abs(dot) > 0.1 * float(
        torch.sqrt(sum(torch.sum(x.double() ** 2) for x in g.values()))
        * torch.sqrt(sum(torch.sum(x.double() ** 2) for x in replay.values())))
    model = port_model(v, C)
    state = TrainState(model, make_optimizer(tcfg.ScheduleConfig(lr=LR), model))
    applied = {}
    real_step = state.optimizer.step

    def capture():
        applied.update({n: p.grad.clone() for n, p in model.named_parameters()})
        real_step()

    state.optimizer.step = capture
    step = tstep.make_train_step(model, None, ANCHORS, tcfg.ILConfig(), tcfg.FocalConfig(),
                                 tlosses.LossStatics(num_classes=C),
                                 tstep.StepStatics(every_iter=1, use_clip=False,
                                                   use_agem=True))
    step(state, *batch, replay_grad=replay)
    got = port_values(applied)
    if sign > 0:
        assert_grads_close(got, port_values(g))
    else:
        rr = sum(float(torch.sum(x.double() ** 2)) for x in replay.values())
        want = {k: (g[k].double() - dot / rr * replay[k].double()).numpy() for k in g}
        assert_grads_close(got, want)
        after = sum(float(np.sum(np.float64(got[k]) * replay[k].double().numpy())) for k in g)
        assert abs(after) < 1e-4 * abs(dot)


# ------------------------------------------------------------ the trainer

DATA = dict(batch_size=2, min_side=96, max_side=96, height=128, width=128, max_boxes=8,
            num_workers=0, prefetch=0)
SIM = np.array([[0.6, 0.3, 0.1], [0.2, 0.5, 0.3]], np.float32)
MAS_AGEM_IL = dict(
    distill=jcfg.DistillConfig(enabled=True),
    replay=jcfg.ReplayConfig(sample_num=2, sample_method="random", sample_batch_size=2),
    mas=jcfg.MASConfig(enabled=True, ratio=0.5),
    agem=jcfg.AGEMConfig(enabled=True, refresh_every=2),
)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """12 PNG images at 96 x 96, 5 classes."""
    root = str(tmp_path_factory.mktemp("toy_mas_agem"))
    json_path = make_toy_dataset(root, num_images=12, image_size=(96, 96), seed=5)
    return json_path, os.path.join(root, "images")


def jax_cfg(ckpt_dir, **il):
    return jcfg.TrainConfig(
        model=jcfg.ModelConfig(**CFG), data=jcfg.DataConfig(**DATA),
        schedule=jcfg.ScheduleConfig(lr=LR, every_iter=1, new_state_epoch=1),
        il=jcfg.ILConfig(scenario=("3", "2"), end_state=1, init_method="mean", **il),
        checkpoint_dir=ckpt_dir, start_epoch=1, end_epoch=1, save_every=1, record=False,
    )


def port_cfg(jc, **changes) -> tcfg.TrainConfig:
    return tcfg.TrainConfig.from_json(jc.to_json()).replace(**changes)


def _spy(trainer, log: list, refreshes: list):
    """Record (state, is_replay, metric keys, total_loss) per micro-step
    and the state of each A-GEM refresh."""
    orig = trainer.run_batch

    def run_batch(batch, is_replay=False, sync_metrics=True, correction=False):
        m = orig(batch, is_replay=is_replay, sync_metrics=True, correction=correction)
        log.append((trainer.cur_state, is_replay, sorted(m), m["total_loss"]))
        return m

    trainer.run_batch = run_batch
    real_init = trainer._init_agem

    def init_agem():
        real_init()
        if trainer.agem is not None:
            real = trainer.agem.compute_replay_grad

            def compute(model=None):
                refreshes.append(trainer.cur_state)
                return real(model)

            trainer.agem.compute_replay_grad = compute

    trainer._init_agem = init_agem


@pytest.fixture(scope="module")
def two_state(toy, tmp_path_factory):
    """JAX's and the port's trainers from the same initial weights through
    train_process: state 0, then state 1 with distillation, random replay
    (2 per old class), MAS (ratio 0.5) and A-GEM (refresh every 2
    micro-steps); the ``mean`` warm-start from a seeded similarity
    sidecar."""
    json_path, images = toy
    tmp = tmp_path_factory.mktemp("two_state_mas_agem")
    jc = jax_cfg(str(tmp / "jax" / "ckpt"), **MAS_AGEM_IL)
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp / "jax"))
    pt = ILTrainer(port_cfg(jc, checkpoint_dir=str(tmp / "port" / "ckpt")), json_path, images,
                   workdir=str(tmp / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    jt.ckpt.save_array_sidecar(0, "similarity", [SIM])
    pt.ckpt.save_array_sidecar(0, "similarity", {"[0]": SIM})
    steps, refreshes = [], []
    _spy(pt, steps, refreshes)
    j_train_process(jt)
    train_process(pt)
    yield dict(jt=jt, pt=pt, jc=jc, tmp=tmp, steps=steps, refreshes=refreshes)
    shutil.rmtree(tmp, ignore_errors=True)


def test_two_state_mas_agem_train_process_matches_jax(two_state):
    """Every micro-step's total_loss at rtol 1e-4 against JAX's; at state
    1 ``mas_loss`` in every new-image micro-step, no replay micro-step
    (A-GEM carries the replay set), and a replay-gradient refresh before
    every second new-image micro-step; the replay gradient is keyed by the
    expanded model's parameters."""
    jt, pt, steps = two_state["jt"], two_state["pt"], two_state["steps"]
    got, want = list(pt.loss_hist), list(jt.loss_hist)
    assert len(got) == len(want) and len(got) > pt.epoch_log[0]["micro_steps"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g)
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"micro-step {i}")
    state1 = [s for s in steps if s[0] == 1]
    assert state1 and not any(r for _, r, _, _ in state1)
    assert all({"mas_loss", "dist_feat_loss"} <= set(k) for _, _, k, _ in state1)
    n1 = len(state1)
    assert two_state["refreshes"] == [1] * ((n1 + 1) // 2)
    assert pt.agem.replay_grad["classification_head.output.weight"].shape[0] == 9 * C
    assert list(pt.dataset_replay.image_ids) == list(jt.dataset_replay.image_ids)


def test_mas_importance_sidecar_matches_jax(two_state):
    """The state-0 ``mas_importance`` sidecar (written by ``next_state``
    with the state-0 model on its data), keyed by the port's parameter
    names, holds JAX's leaves at the gradient bar; the trainer's
    importance is the sidecar's, and its previous parameters are the
    teacher's."""
    jt, pt = two_state["jt"], two_state["pt"]
    got = pt.ckpt.load_array_sidecar(0, "mas_importance")
    want = to_port(jt.ckpt.load_array_sidecar(0, "mas_importance", like=jax.tree.map(
        np.asarray, jt.teacher_variables["params"])))
    assert_grads_close(got, want, "importance")
    assert got["classification_head.output.weight"].shape[0] == 9 * C_OLD
    for k, v in pt.mas_importance.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
    teacher = dict(pt.teacher_model.named_parameters())
    assert pt.mas_prev_params.keys() == teacher.keys()
    assert all(pt.mas_prev_params[k] is teacher[k] for k in teacher)


def test_cross_state_entry_reads_the_mas_sidecar(two_state, toy):
    """``start_state=1`` in a fresh run directory holding the state-0
    checkpoint and its similarity and ``mas_importance`` sidecars: the
    importance read back equals ``next_state``'s (the expanded classifier
    output zeroed, its shape changed), and the state-1 losses equal the
    unbroken run's bit for bit."""
    json_path, images = toy
    pt = two_state["pt"]
    tmp = two_state["tmp"] / "entry"
    dst = tmp / "ckpt" / "3_2" / "state0"
    shutil.copytree(os.path.join(pt.ckpt.state_dir(0), "epoch1"), dst / "epoch1")
    for name in ("similarity.npz", "mas_importance.npz"):
        shutil.copy(os.path.join(pt.ckpt.state_dir(0), name), dst / name)
    cfg = port_cfg(two_state["jc"], checkpoint_dir=str(tmp / "ckpt"))
    cfg = cfg.replace(il=dataclasses.replace(cfg.il, start_state=1))
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp), device="cpu")
    assert tr.cur_state == 1 and tr.num_classes == C
    assert tr.mas_importance.keys() == pt.mas_importance.keys()
    out = ("classification_head.output.weight", "classification_head.output.bias")
    for k, v in tr.mas_importance.items():
        if k in out:
            assert v.shape[0] == 9 * C != pt.mas_importance[k].shape[0] and not v.any(), k
        else:
            np.testing.assert_array_equal(v.numpy(), pt.mas_importance[k].numpy(), err_msg=k)
    train_process(tr)
    n0 = pt.epoch_log[0]["micro_steps"]
    assert list(tr.loss_hist) == list(pt.loss_hist)[n0:]


def test_cross_state_entry_without_a_sidecar_uses_the_expanded_model(two_state, toy):
    """A JAX quirk kept: with no ``mas_importance`` sidecar, the entry
    computes the importance with the expanded state-1 model on the
    state-1 training images (``next_state`` uses the state-0 model on the
    state-0 images) and writes it as state 0's sidecar."""
    json_path, images = toy
    pt = two_state["pt"]
    tmp = two_state["tmp"] / "entry_fresh"
    dst = tmp / "ckpt" / "3_2" / "state0"
    shutil.copytree(os.path.join(pt.ckpt.state_dir(0), "epoch1"), dst / "epoch1")
    shutil.copy(os.path.join(pt.ckpt.state_dir(0), "similarity.npz"), dst / "similarity.npz")
    cfg = port_cfg(two_state["jc"], checkpoint_dir=str(tmp / "ckpt"))
    cfg = cfg.replace(il=dataclasses.replace(cfg.il, start_state=1))
    seen = {}
    real = mas.compute_importance

    def spy(model, anchors, loader, mesh=None):
        seen["classes"] = model.classification_head.output.weight.shape[0] // 9
        seen["images"] = list(loader.dataset.image_ids)
        return real(model, anchors, loader, mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("cl_object_detection_tpu_torch.train.trainer.compute_importance", spy)
        tr = ILTrainer(cfg, json_path, images, workdir=str(tmp), device="cpu")
    assert seen["classes"] == C and seen["images"] == list(tr.dataset_train.image_ids)
    written = tr.ckpt.load_array_sidecar(0, "mas_importance")
    assert written["classification_head.output.weight"].shape[0] == 9 * C
    for k, v in tr.mas_importance.items():
        np.testing.assert_array_equal(v.numpy(), written[k], err_msg=k)
        assert np.isfinite(written[k]).all()
