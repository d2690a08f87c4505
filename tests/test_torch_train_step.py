"""The port's train step at state 0 against the JAX package's, from one set
of weights carried across by ``models.bridge``, in float32 on the CPU:
an R18 RetinaNet (FPN 32, 2 head layers), 64 x 96 frames, 3 classes.

Tolerances, each from the reduction order or the float32 constants:
  * metrics at rtol 1e-4;
  * gradients (and gradient accumulators) leaf by leaf at
    |d| <= 1e-3 |g_jax| + 1e-4 max|g_jax| of the leaf;
  * parameter deltas after an apply: where |g_jax| >= 1e-3 max|g_jax| of
    the leaf, within 1e-3 lr; on a first Adam step everywhere
    |d| <= lr (1 + 1e-6). Elements far below the leaf's largest gradient
    may take Adam's normalisation to either sign, so only their size is
    held. A delta is a difference of float32 parameters, so each bound
    also allows one float32 spacing of the parameter;
  * JAX's gradient is its jitted ``value_and_grad`` of
    ``compute_losses`` (``jax_gradient``): make_train_step's own
    compile moves the fused stem's gradients by up to 3.5e-3 of the
    leaf's largest, so accumulators and the applies of the every_iter=2
    step are held to ``jax_gradient`` and ``jax_reference_apply``, and
    the step's metrics, which its updates move, to make_train_step;
  * the optimizer against optax (eager, so that XLA does not contract
    its moment updates into FMAs): moments at rtol 1e-6 (they agree to
    the bit); parameters at rtol 1e-6 plus 1e-5 lr per step, because
    the bias corrections 1 - b^t are float32 powers that XLA's pow and
    numpy's round an ulp apart, and 1 - 0.999^t carries that ulp at a
    relative 6e-5 / t into the update.

Three JAX step variants are built: ``every_iter=2`` with the clip;
``every_iter=1`` with the ``"output"`` warm-stage mask and
``warm_classifier``; ``every_iter=1`` with ``enhance_only``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.il.losses import LossStatics as JLossStatics
from cl_object_detection_tpu.il.losses import compute_losses as j_compute_losses
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.ops.stem_pallas import pack_stem_kernel as j_pack_stem_kernel
from cl_object_detection_tpu.ops.stem_pallas import stem_fused as j_stem_fused
from cl_object_detection_tpu.train import optim as joptim
from cl_object_detection_tpu.train import step as jstep
from cl_object_detection_tpu.train.state import TrainState as JTrainState
from cl_object_detection_tpu.train.trainer import trainable_mask as j_trainable_mask
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.data.transforms import space_to_depth
from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
from cl_object_detection_tpu_torch.models.bridge import (
    load_jax_variables,
    load_optax_state,
    port_name,
)
from cl_object_detection_tpu_torch.models.resnet import FrozenBN
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.ops import stem_fused as tsf
from cl_object_detection_tpu_torch.ops.pool import phase_pool
from cl_object_detection_tpu_torch.train import optim as toptim
from cl_object_detection_tpu_torch.train import step as tstep
from cl_object_detection_tpu_torch.train.state import TrainState
from cl_object_detection_tpu_torch.train.trainer import trainable_mask

torch.set_num_threads(1)

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
C = 3
H, W = 64, 96
LR = 1e-4


# ----------------------------------------------------------------- helpers

def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def to_port(params) -> dict:
    """A JAX ``params``-shaped tree as {port name: float32 numpy, OIHW}."""
    out = {}
    for path, val in _leaves(jax.tree.map(np.asarray, params)):
        arr = np.asarray(val, np.float32)
        out[port_name(("params",) + path)] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return out


def port_values(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def assert_grads_close(got: dict, want: dict, what="grad"):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for name, w in want.items():
        g = got[name]
        tol = 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()
        bad = np.abs(g - w) > tol
        assert not bad.any(), (f"{what} {name}: {int(bad.sum())} of {w.size} beyond tolerance, "
                               f"max |d| {np.abs(g - w).max():.3g}, max |g| {np.abs(w).max():.3g}")


def assert_deltas_close(got: dict, want: dict, g_apply: dict, lr_of, first_step: bool,
                        before: dict):
    """Parameter deltas of one apply (see the module docstring). A delta
    is the difference of two float32 parameters, so each bound also
    allows one float32 spacing of the parameter (1.2e-7 at |p| ~ 1, more
    than 1e-3 lr)."""
    for name, w in want.items():
        d, lr = got[name], lr_of(name)
        ulp = np.spacing(np.abs(before[name]))
        g = np.abs(g_apply[name])
        sel = g >= 1e-3 * g.max() if g.max() > 0 else np.zeros_like(g, bool)
        bad = sel & (np.abs(d - w) > 1e-3 * lr + ulp)
        assert not bad.any(), (f"{name}: {int(bad.sum())} well-determined elements off, "
                               f"max {np.abs(d - w)[bad].max():.3g} (lr {lr})")
        assert np.isfinite(d).all(), name
        if first_step:
            assert (np.abs(d) <= lr * (1 + 1e-6) + ulp).all(), (name, np.abs(d).max(), lr)


def assert_metrics_close(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def randomize(variables, seed):
    """Non-trivial BN statistics and affines, random output convs."""
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
            # logits and deltas of std ~1 around the init's biases (the
            # classifier's prior -4.6): saturated sigmoids would put
            # probabilities on the 1 - 1e-4 clip bound, where the
            # gradient jumps between 0, 0.5 and 1 with the last ulp
            if keys[-1] == "kernel":
                return (r.randn(*x.shape) * 0.0015).astype(np.float32)
            return (x + r.randn(*x.shape) * 0.05).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@functools.lru_cache(maxsize=None)
def jax_model():
    model = j_create(jcfg.ModelConfig(**CFG), C)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    return model, randomize(v, 100)


def port_model(variables, **cfg):
    model = create_retinanet(tcfg.ModelConfig(**{**CFG, **cfg}), C, device="cpu")
    load_jax_variables(model, jax.tree.map(np.asarray, variables))
    return model


def make_batch(seed, frames="fused"):
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (3, H, W, 3)).astype(np.uint8)
    if frames == "fused":
        x = space_to_depth(img, factor=4)
    else:
        x = ((img.astype(np.float32) / 255.0 - 0.45) / 0.225).astype(np.float32)
    boxes = np.full((3, 5, 4), -1, np.float32)
    labels = np.full((3, 5), -1, np.int32)
    for b, n in ((0, 3), (1, 2)):          # image 2 has no GT
        for j in range(n):
            x1, y1 = r.uniform(0, 50), r.uniform(0, 25)
            boxes[b, j] = [x1, y1, x1 + r.uniform(20, 45), y1 + r.uniform(20, 38)]
            labels[b, j] = r.randint(0, C)
    return x, boxes, labels


def jargs(batch):
    return tuple(jnp.asarray(a) for a in batch)


def targs(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


ANCHORS = anchors_for_shape(H, W)
LOSS_KINDS = {
    "normal": dict(num_classes=C),
    "replay": dict(num_classes=C, num_past_class=1, is_replay=True, use_enhance_error=True),
}


def jax_gradient(model, batch, kind="normal"):
    """JAX's gradient of ``compute_losses`` (jitted ``value_and_grad``) at
    the port model's current parameters. It is the reference for the
    port's accumulators and applies, not make_train_step's own gradient:
    XLA's compile of the whole step moves the fused stem's gradients
    (conv1, bn1, layer1) by 1e-4 to 3.5e-3 of the leaf's largest, with
    the execution mode (the jitted step, the step under
    ``jax.disable_jit``), where this function and a float64 run of the
    port agree to ~1e-6. That is as large as the 1e-3 selection of
    ``assert_deltas_close``, so make_train_step's updates of those
    leaves are no reference at its tolerance; its metrics, which the
    updates move, are."""
    (_, _), g = jax_loss_grad(kind)(
        to_jax({n: p.detach().numpy() for n, p in model.named_parameters()}), *jargs(batch))
    return to_port(g)


def to_jax(values: dict):
    """{port name: array} back onto JAX's params tree (OIHW -> HWIO)."""
    _, v = jax_model()

    def leaf(path, x):
        arr = np.asarray(values[port_name(("params",) + tuple(p.key for p in path))])
        return jnp.asarray(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr)

    return jax.tree_util.tree_map_with_path(leaf, v["params"])


def jax_reference_apply(params: dict, opt_state, tx, grads: dict, clip: float):
    """make_train_step's apply (clip, then the optax update) from JAX's
    own functions, eagerly, on ``grads``: the reference for the port's
    parameters and moments after an apply (see ``jax_gradient``)."""
    g = jstep._clip_by_global_norm(to_jax(grads), clip)
    p = to_jax(params)
    updates, opt_state = tx.update(g, opt_state, p)
    return to_port(optax.apply_updates(p, updates)), opt_state


@functools.lru_cache(maxsize=None)
def jax_loss_grad(kind):
    model, v = jax_model()
    statics = JLossStatics(**LOSS_KINDS[kind])

    def loss_fn(params, images, boxes, labels):
        return j_compute_losses(
            lambda vv, x, act: model.apply(vv, x, enable_act=act), None,
            {"params": params, "batch_stats": v["batch_stats"]}, images, boxes, labels,
            jnp.asarray(ANCHORS), jcfg.ILConfig(), jcfg.FocalConfig(), statics)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# ------------------------------------------------------- configs and labels

@pytest.mark.parametrize("name", ["FocalConfig", "ScheduleConfig", "ILConfig", "ModelConfig"])
def test_config_copies_match_jax(name):
    """Same fields and defaults, nested configs included, so one
    params.json reads in both packages."""
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("warm_kind", [None, "output", "fpn", "resnet"])
def test_param_labels_and_trainable_mask_match_jax(warm_kind):
    _, v = jax_model()
    model = port_model(v)
    want_labels = {port_name(("params",) + p): lab
                   for p, lab in _leaves(joptim.param_labels(v["params"]))}
    assert toptim.param_labels(model) == want_labels
    jmask = j_trainable_mask(v["params"], warm_kind)
    mask = trainable_mask(model, warm_kind)
    if warm_kind is None:
        assert jmask is None and mask is None
        return
    want = {}
    for path, leaf in _leaves(jax.tree.map(np.asarray, jmask)):
        assert np.all(leaf == leaf.flat[0])
        want[port_name(("params",) + path)] = float(leaf.flat[0])
    assert mask == want
    assert 0 < sum(mask.values()) < len(mask)


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("kind", sorted(LOSS_KINDS))
@pytest.mark.parametrize("frames", ["rgb", "fused"])
def test_compute_losses_plain_path_matches_jax(frames, kind):
    """Metrics and the gradient of total_loss for every parameter, the
    stem conv's and bn1's included (on fused frames they come through
    the stem Function's backward)."""
    _, v = jax_model()
    batch = make_batch(1, frames)
    (_, jmetrics), jgrads = jax_loss_grad(kind)(v["params"], *jargs(batch))
    model = port_model(v)
    total, metrics = compute_losses(model, *targs(batch), torch.from_numpy(ANCHORS),
                                    tcfg.ILConfig(), tcfg.FocalConfig(),
                                    LossStatics(**LOSS_KINDS[kind]))
    total.backward()
    assert_metrics_close(metrics, jmetrics)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want = to_port(jgrads)
    assert_grads_close(grads, want)
    for name in ("backbone.conv1.weight", "backbone.bn1.weight", "backbone.bn1.bias"):
        assert np.abs(grads[name]).max() > 0, name
    if kind == "replay":
        assert "enhance_loss" in metrics


def test_incremental_losses_are_not_ported_yet():
    """The MAS penalty (item 4c, once refused here) and the prototype loss
    (item 4b) run in compute_losses and in a train step with a teacher:
    ``mas_loss`` finite and positive against previous parameters moved
    off the model's, the prototype term finite and positive against old
    prototypes at the origin."""
    _, v = jax_model()
    model = port_model(v)
    batch = targs(make_batch(1))
    mas = LossStatics(num_classes=C, use_mas=True)
    teacher = port_model(v)
    prev = {k: p.detach() + 1e-3 for k, p in teacher.named_parameters()}
    importance = {k: torch.ones_like(p) for k, p in prev.items()}
    mas_kw = dict(mas_prev_params=prev, mas_importance=importance)
    _, metrics = compute_losses(model, *batch, torch.from_numpy(ANCHORS), tcfg.ILConfig(),
                                tcfg.FocalConfig(), mas, **mas_kw)
    assert float(metrics["mas_loss"].detach()) > 0
    step = tstep.make_train_step(model, teacher, ANCHORS, tcfg.ILConfig(),
                                 tcfg.FocalConfig(), mas, tstep.StepStatics())
    mas_state = TrainState(model, toptim.make_optimizer(tcfg.ScheduleConfig(), model))
    mas_state, metrics = step(mas_state, *batch, **mas_kw)
    assert mas_state.step == 1 and np.isfinite(float(metrics["mas_loss"]))
    assert float(metrics["mas_loss"]) > 0
    state = TrainState(model, toptim.make_optimizer(tcfg.ScheduleConfig(), model))
    proto = LossStatics(num_classes=C, num_past_class=1, incremental=True, use_prototype=True)
    old = torch.zeros(1, model.classification_head.conv1.weight.shape[0] * 9)
    _, metrics = compute_losses(model, *batch, torch.from_numpy(ANCHORS), tcfg.ILConfig(),
                                tcfg.FocalConfig(), proto, prototype_features=old)
    assert float(metrics["prototype_loss"].detach()) > 0
    step = tstep.make_train_step(model, port_model(v), ANCHORS, tcfg.ILConfig(),
                                 tcfg.FocalConfig(), proto, tstep.StepStatics(every_iter=1))
    state, metrics = step(state, *batch, prototype_features=old)
    assert state.step == 1 and np.isfinite(float(metrics["prototype_loss"]))
    assert np.isfinite(float(metrics["total_loss"]))


# ----------------------------------------------------------------- optimizer

def _optax_group_state(opt_state):
    """optax's multi_transform state -> the bridge's per-group form."""
    out = {}
    for name, masked in opt_state[0].inner_states.items():
        inject = masked.inner_state
        adam = inject.inner_state[0]
        out[name] = {"count": np.asarray(adam.count),
                     **{k: np.asarray(x) for k, x in inject.hyperparams.items()},
                     "mu": jax.tree.map(np.asarray, _drop_masked(adam.mu)),
                     "nu": jax.tree.map(np.asarray, _drop_masked(adam.nu))}
    return out


def _drop_masked(tree):
    """A multi_transform moment tree without the other group's leaves."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _drop_masked(x) for k, x in tree.items() if not isinstance(x, optax.MaskedNode)}
    return {k: x for k, x in out.items() if not (isinstance(x, dict) and not x)}


def _port_moments(model, opt):
    names = {id(p): n for n, p in model.named_parameters()}
    return ({names[id(p)]: s["mu"].numpy() for p, s in opt.state.items()},
            {names[id(p)]: s["nu"].numpy() for p, s in opt.state.items()})


def _jax_moments(opt_state):
    groups = _optax_group_state(opt_state)
    mu, nu = {}, {}
    for g in groups.values():
        mu.update(to_port(g["mu"]))
        nu.update(to_port(g["nu"]))
    return mu, nu


def test_optimizer_matches_optax():
    """Four gradient trees through the two groups (output lr x 10):
    set_learning_rate after the first, set_beta1(0.5, "output") before
    the third (bias correction with the swapped b1 at the shared count),
    and an all-zero gradient for the output group on the fourth (its
    moments and parameters still move, as optax's do)."""
    _, v = jax_model()
    params = v["params"]
    sched = jcfg.ScheduleConfig(lr=1e-3, classifier_lr_scale=10.0)
    tx = joptim.make_optimizer(sched, params, use_clip=False)
    jstate = tx.init(params)
    model = port_model(v)
    opt = toptim.make_optimizer(tcfg.ScheduleConfig(lr=1e-3, classifier_lr_scale=10.0), model)
    r = np.random.RandomState(7)
    p = params
    lrs = {"backbone": 1e-3, "output": 1e-2}
    for i in range(4):
        g = jax.tree.map(lambda x: jnp.asarray(r.randn(*x.shape).astype(np.float32) * 0.1), params)
        if i == 3:
            g = {**g, "classification_head": {**g["classification_head"], "output": jax.tree.map(
                jnp.zeros_like, g["classification_head"]["output"])}}
        if i == 1:
            jstate = joptim.set_learning_rate(jstate, 5e-4, classifier_scale=10.0)
            toptim.set_learning_rate(opt, 5e-4, classifier_scale=10.0)
            lrs = {"backbone": 5e-4, "output": 5e-3}
        if i == 2:
            jstate = joptim.set_beta1(jstate, 0.5, where="output")
            toptim.set_beta1(opt, 0.5, where="output")
        u, jstate = tx.update(g, jstate, p)                # eager: no FMA contraction
        p = optax.apply_updates(p, u)
        tg = to_port(g)
        for name, par in model.named_parameters():
            par.grad = torch.from_numpy(tg[name])
        opt.step()
    jhp = joptim.get_hyperparams(jstate)
    for group, hp in toptim.get_hyperparams(opt).items():
        assert hp == pytest.approx({k: jhp[group][k] for k in hp}, rel=1e-7), group
    assert [g["count"] for g in opt.param_groups] == [4, 4]
    want = to_port(p)
    labels = toptim.param_labels(model)
    for name, par in model.named_parameters():
        atol = 1e-5 * lrs[labels[name]] * 4
        np.testing.assert_allclose(par.detach().numpy(), want[name], rtol=1e-6, atol=atol,
                                   err_msg=name)
    jmu, jnu = _jax_moments(jstate)
    mu, nu = _port_moments(model, opt)
    for got, exp, what in ((mu, jmu, "mu"), (nu, jnu, "nu")):
        assert set(got) == set(exp)
        for name in exp:
            np.testing.assert_allclose(got[name], exp[name], rtol=1e-6, atol=0,
                                       err_msg=f"{what} {name}")
    assert [toptim.lr_at_epoch(tcfg.ScheduleConfig(), e) for e in (0, 40, 41, 100)] == \
        [joptim.lr_at_epoch(jcfg.ScheduleConfig(), e) for e in (0, 40, 41, 100)]


def test_optimizer_refuses_a_missing_gradient():
    """A None gradient would let a parameter skip a step that optax takes."""
    _, v = jax_model()
    model = port_model(v)
    opt = toptim.make_optimizer(tcfg.ScheduleConfig(), model)
    for par in model.parameters():
        par.grad = torch.zeros_like(par)
    model.backbone.conv1.weight.grad = None
    with pytest.raises(ValueError, match="gradient"):
        opt.step()


# ------------------------------------------------------------- step helpers

def _grad_tree(seed, max_size=None):
    """Random gradients shaped like the model's params; with ``max_size``,
    only the leaves of at most that many elements (whose float32 sums
    are exact to ~1e-7 in JAX's sequential reduction as in the port's)."""
    _, v = jax_model()
    r = np.random.RandomState(seed)
    tree = jax.tree.map(lambda x: r.randn(*x.shape).astype(np.float32), v["params"])

    def prune(t):
        out = {k: prune(x) if isinstance(x, dict) else x for k, x in t.items()
               if isinstance(x, dict) or max_size is None or x.size <= max_size}
        return {k: x for k, x in out.items() if not (isinstance(x, dict) and not x)}

    return prune(tree)


def _scaled(tree, norm):
    total = np.sqrt(sum(np.sum(np.float64(x) ** 2) for _, x in _leaves(tree)))
    return jax.tree.map(lambda x: jnp.asarray((x * (norm / total)).astype(np.float32)), tree)


def _port_grads(tree):
    return {k: torch.from_numpy(a) for k, a in to_port(tree).items()}


@pytest.mark.parametrize("norm", [50.0, 0.05, 1e-7])
def test_clip_by_global_norm_matches_jax(norm):
    """Norm above the limit 0.1 (scaled down), below it (unchanged), and
    under the 1e-6 floor (scale 0.1 / 1e-6, capped at 1). Against JAX's
    function on the small leaves; on the whole model-shaped tree against
    JAX's formula in float64 (JAX's own float32 sum of 11M squares is
    off by ~5e-5 there)."""
    small = _scaled(_grad_tree(3, max_size=512), norm)
    want = to_port(jstep._clip_by_global_norm(small, 0.1))
    got = port_values(tstep._clip_by_global_norm(_port_grads(small), 0.1))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    full = _scaled(_grad_tree(3), norm)
    g64 = {k: np.float64(a) for k, a in to_port(full).items()}
    n64 = np.sqrt(sum(np.sum(a * a) for a in g64.values()))
    scale = min(1.0, 0.1 / max(n64, 1e-6))
    got = port_values(tstep._clip_by_global_norm(_port_grads(full), 0.1))
    for k, a in g64.items():
        np.testing.assert_allclose(got[k], a * scale, rtol=1e-6, atol=0, err_msg=k)
    assert (scale < 1.0) == (norm > 0.1)


def test_zero_old_class_grads_matches_jax():
    g = jax.tree.map(jnp.asarray, _grad_tree(4))
    for past in (0, 1, 2):
        ss = dict(warm_classifier=True, num_past_class=past, num_knowing_class=C)
        want = to_port(jstep._zero_old_class_grads(g, jstep.StepStatics(**ss)))
        got = port_values(tstep._zero_old_class_grads(_port_grads(g), tstep.StepStatics(**ss)))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_agem_project_matches_jax(sign):
    """<g, g_r> negative (projected) and positive (unchanged): against
    JAX's function on the small leaves, against its formula in float64
    on the whole tree."""
    for max_size in (512, None):
        g = _grad_tree(5, max_size)
        noise = _grad_tree(6, max_size)
        ref = jax.tree.map(lambda x, n: sign * x + 0.3 * n, g, noise)
        got = port_values(tstep._agem_project(_port_grads(g), _port_grads(ref)))
        gp, rp = to_port(g), to_port(ref)
        if max_size is not None:
            want = to_port(jstep._agem_project(jax.tree.map(jnp.asarray, g),
                                               jax.tree.map(jnp.asarray, ref)))
        else:
            dot = sum(np.sum(np.float64(gp[k]) * rp[k]) for k in gp)
            rr = sum(np.sum(np.float64(rp[k]) ** 2) for k in rp)
            coef = dot / max(rr, 1e-12) if dot < 0 else 0.0
            want = {k: gp[k] - coef * np.float64(rp[k]) for k in gp}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(want[k]).max(), err_msg=k)
        moved = any(not np.array_equal(got[k], gp[k]) for k in gp)
        assert moved == (sign < 0)


# ------------------------------------------------------------ the step itself

@functools.lru_cache(maxsize=None)
def jax_step(variant):
    model, v = jax_model()
    if variant == "accumulate":
        ls, ss = JLossStatics(num_classes=C), jstep.StepStatics(every_iter=2, grad_clip=0.1)
    elif variant == "warm":
        ls = JLossStatics(num_classes=C, num_past_class=1)
        ss = jstep.StepStatics(every_iter=1, use_clip=False, warm_classifier=True,
                               num_past_class=1, num_knowing_class=C)
    else:
        ls = JLossStatics(num_classes=C, num_past_class=1, is_replay=True,
                          use_enhance_error=True, enhance_only=True)
        ss = jstep.StepStatics(every_iter=1, use_clip=False)
    step = jstep.make_train_step(model, None, jnp.asarray(ANCHORS), jcfg.ILConfig(),
                                 jcfg.FocalConfig(), ls, ss, donate=False)
    return step, ls, ss


def _statics_to_port(ls, ss):
    return (LossStatics(**dataclasses.asdict(ls)), tstep.StepStatics(**dataclasses.asdict(ss)))


def _pair(variant, variables, every_iter):
    """(JAX state, port state, port step) from one variable tree."""
    step, ls, ss = jax_step(variant)
    tx = joptim.make_optimizer(jcfg.ScheduleConfig(lr=LR, every_iter=every_iter),
                               variables["params"], use_clip=False)
    jstate = JTrainState.create(params=variables["params"],
                                batch_stats=variables["batch_stats"], tx=tx)
    model = port_model(variables)
    state = TrainState(model, toptim.make_optimizer(
        tcfg.ScheduleConfig(lr=LR, every_iter=every_iter), model))
    tls, tss = _statics_to_port(ls, ss)
    tstep_fn = tstep.make_train_step(model, None, ANCHORS, tcfg.ILConfig(),
                                     tcfg.FocalConfig(), tls, tss)
    return step, jstate, state, tstep_fn


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_make_train_step_accumulates_like_jax():
    """every_iter=2, clip 0.1, fused uint8 frames: micro-steps on batches
    A, A, B against make_train_step: metrics at every micro-step (the
    third's at the updated parameters), the counts; the accumulator
    after the first and the third against ``jax_gradient`` at the
    port's parameters (after the apply it holds the one new micro-step's
    gradient); the parameters after the apply against
    ``jax_reference_apply``."""
    _, v = jax_model()
    step, jstate, state, tfn = _pair("accumulate", v, 2)
    tx, opt0 = jstate.tx, jstate.opt_state
    a, b = make_batch(1), make_batch(2)
    p0 = _params(state.model)
    g_apply = None
    for i, batch in enumerate((a, a, b)):
        jstate, jmetrics = step(jstate, *jargs(batch))
        state, metrics = tfn(state, *targs(batch))
        assert_metrics_close(metrics, jmetrics)
        assert state.acc_count == int(jstate.acc_count) == (1, 0, 1)[i]
        assert state.step == int(jstate.step) == i + 1
        if i in (0, 2):
            want = jax_gradient(state.model, batch)
            assert_grads_close(port_values(state.grad_acc), want, "accumulator")
        if i == 0:
            g_apply = want
            for k, x in _params(state.model).items():
                np.testing.assert_array_equal(x, p0[k])      # no apply yet
        if i == 1:
            ref, _ = jax_reference_apply(p0, opt0, tx, g_apply, 0.1)
            jd = {k: x - p0[k] for k, x in ref.items()}
            td = {k: x - p0[k] for k, x in _params(state.model).items()}
            assert_deltas_close(td, jd, g_apply, lambda n: LR, first_step=True, before=p0)
            for name in ("backbone.conv1.weight", "backbone.bn1.weight", "backbone.bn1.bias"):
                assert np.abs(td[name]).max() > 0, name


def test_make_train_step_warm_stage_like_jax():
    """every_iter=1 with the "output" warm-stage mask and warm_classifier
    (class 0 old): only the new-class rows of the classification output
    conv move, as in JAX, over two applies. The elements held to 1e-3 lr
    are chosen by the first step's gradient, which the carried moments
    dominate on the second."""
    _, v = jax_model()
    step, jstate, state, tfn = _pair("warm", v, 1)
    jmask = j_trainable_mask(v["params"], "output")
    mask = trainable_mask(state.model, "output")
    batch = make_batch(1)
    (_, _), g0 = jax_loss_grad("normal")(v["params"], *jargs(batch))
    g_apply = to_port(g0)
    for i in range(2):
        p_before, jp_before = _params(state.model), to_port(jstate.params)
        jstate, jmetrics = step(jstate, *jargs(batch), trainable_mask=jmask)
        state, metrics = tfn(state, *targs(batch), trainable_mask=mask)
        assert_metrics_close(metrics, jmetrics)
        jd = {k: x - jp_before[k] for k, x in to_port(jstate.params).items()}
        td = {k: x - p_before[k] for k, x in _params(state.model).items()}
        masked = {k: g * mask[k] for k, g in g_apply.items()}
        for k in ("classification_head.output.weight", "classification_head.output.bias"):
            rows = masked[k].reshape(9, C, -1)
            rows[:, 0] = 0
        assert_deltas_close(td, jd, masked, lambda n: LR, first_step=(i == 0),
                            before=p_before)
        for k, d in td.items():
            if mask[k] == 0.0:
                assert not d.any(), k
        wd = td["classification_head.output.weight"].reshape(9, C, -1)
        assert not wd[:, 0].any() and wd[:, 1:].any()


def _random_adam_state(jstate, seed):
    """The JAX state with random moments (nu > 0) and count 3."""
    r = np.random.RandomState(seed)

    def leaf(path, x):
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if "mu" in names:
            return jnp.asarray(r.randn(*x.shape).astype(np.float32) * 1e-3)
        if "nu" in names:
            return jnp.asarray(np.abs(r.randn(*x.shape)).astype(np.float32) * 1e-6)
        if names[-1] == "count":
            return jnp.asarray(3, x.dtype)
        return x

    opt = jax.tree_util.tree_map_with_path(leaf, jstate.opt_state)
    return jstate.replace(opt_state=opt)


@pytest.mark.parametrize("loss", ["zero", "positive"])
def test_make_train_step_enhance_only_like_jax(loss):
    """Final correction (every_iter=1, enhance_only) from Adam moments
    carried over by the bridge: a batch whose loss is 0 (output convs 0,
    every new-class score at the prior 0.01) leaves parameters and
    moments untouched, as in JAX; one with a positive loss applies."""
    _, v = jax_model()
    if loss == "zero":
        out = v["params"]["classification_head"]["output"]
        out = {"kernel": jnp.zeros_like(out["kernel"]),
               "bias": jnp.full_like(out["bias"], -np.log((1 - 0.01) / 0.01))}
        v = {**v, "params": {**v["params"], "classification_head": {
            **v["params"]["classification_head"], "output": out}}}
    step, jstate, state, tfn = _pair("enhance", v, 1)
    jstate = _random_adam_state(jstate, 9)
    load_optax_state(state.model, state.optimizer, _optax_group_state(jstate.opt_state))
    p0, jp0 = _params(state.model), to_port(jstate.params)
    mu0, nu0 = _port_moments(state.model, state.optimizer)
    batch = make_batch(3)
    jstate, jmetrics = step(jstate, *jargs(batch))
    state, metrics = tfn(state, *targs(batch))
    assert_metrics_close(metrics, jmetrics)
    assert set(metrics) == {"enhance_loss", "total_loss"}
    mu1, nu1 = _port_moments(state.model, state.optimizer)
    jmu, jnu = _jax_moments(jstate.opt_state)
    counts = [g["count"] for g in state.optimizer.param_groups]
    jcounts = [int(g["count"]) for g in _optax_group_state(jstate.opt_state).values()]
    assert counts == jcounts
    if loss == "zero":
        assert float(metrics["total_loss"]) == 0.0
        assert counts == [3, 3]
        for k, x in _params(state.model).items():
            np.testing.assert_array_equal(x, p0[k])
            np.testing.assert_array_equal(to_port(jstate.params)[k], jp0[k])
        for got, was, exp in ((mu1, mu0, jmu), (nu1, nu0, jnu)):
            for k in got:
                np.testing.assert_array_equal(got[k], was[k])
                np.testing.assert_array_equal(exp[k], was[k])
    else:
        assert float(metrics["total_loss"]) > 0
        assert counts == [4, 4]
        jd = {k: x - jp0[k] for k, x in to_port(jstate.params).items()}
        td = {k: x - p0[k] for k, x in _params(state.model).items()}
        # the enhance term reaches only the classification branch and the
        # trunk; every parameter still moves on its carried moments
        ulp = {k: np.spacing(np.abs(x)) for k, x in p0.items()}
        for k, w in jd.items():
            tol = 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max() + ulp[k]
            assert not (np.abs(td[k] - w) > tol).any(), k
        assert_grads_close(mu1, jmu, "mu")
        assert_grads_close(nu1, jnu, "nu")


def test_optax_state_bridge_carries_a_jax_run():
    """Two applies of make_train_step (every_iter=2, four micro-steps),
    then its parameters and optax state carried into the port; one more
    apply in each: metrics against the JAX step, the accumulator against
    ``jax_gradient``, parameters and moments against
    ``jax_reference_apply`` from the carried state."""
    _, v = jax_model()
    step, jstate, _, _ = _pair("accumulate", v, 2)
    batch = make_batch(4)
    for _ in range(4):
        jstate, _ = step(jstate, *jargs(batch))
    carried = {"params": jstate.params, "batch_stats": v["batch_stats"]}
    _, _, state, tfn = _pair("accumulate", carried, 2)
    load_optax_state(state.model, state.optimizer, _optax_group_state(jstate.opt_state))
    assert [g["count"] for g in state.optimizer.param_groups] == [2, 2]
    tx, opt_carried = jstate.tx, jstate.opt_state
    p0 = _params(state.model)
    batch2 = make_batch(5)
    g_apply = None
    for i in range(2):
        jstate, jmetrics = step(jstate, *jargs(batch2))
        state, metrics = tfn(state, *targs(batch2))
        assert_metrics_close(metrics, jmetrics)
        if i == 0:
            g_apply = jax_gradient(state.model, batch2)
            assert_grads_close(port_values(state.grad_acc), g_apply, "accumulator")
    ref, ref_opt = jax_reference_apply(p0, opt_carried, tx, g_apply, 0.1)
    jd = {k: x - p0[k] for k, x in ref.items()}
    td = {k: x - p0[k] for k, x in _params(state.model).items()}
    assert_deltas_close(td, jd, g_apply, lambda n: LR, first_step=False, before=p0)
    assert [g["count"] for g in state.optimizer.param_groups] == [3, 3]
    mu, nu = _port_moments(state.model, state.optimizer)
    jmu, jnu = _jax_moments(ref_opt)
    assert_grads_close(mu, jmu, "mu")
    assert_grads_close(nu, jnu, "nu")


def test_optax_state_bridge_is_strict():
    _, v = jax_model()
    model = port_model(v)
    opt = toptim.make_optimizer(tcfg.ScheduleConfig(), model)
    tx = joptim.make_optimizer(jcfg.ScheduleConfig(), v["params"], use_clip=False)
    good = _optax_group_state(tx.init(v["params"]))
    load_optax_state(model, opt, good)
    bad = {**good, "output": {**good["output"], "mu": {}}}
    with pytest.raises(ValueError, match="no JAX leaf"):
        load_optax_state(model, opt, bad)
    bad = {**good, "backbone": {**good["backbone"], "mu": {**good["backbone"]["mu"],
                                                           "classification_head": good["output"]["mu"]["classification_head"]}}}
    with pytest.raises(ValueError, match="no param of the group"):
        load_optax_state(model, opt, bad)
    with pytest.raises(ValueError, match="groups"):
        load_optax_state(model, opt, {"backbone": good["backbone"]})
    with pytest.raises(ValueError, match="eps_root"):
        load_optax_state(model, opt, {**good, "output": {**good["output"], "eps_root": 1e-8}})


# ---------------------------------------------------------------- port only

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frozen_bn_grad_branch_bit_identical_to_inference(dtype):
    g = torch.Generator().manual_seed(3)
    bn = FrozenBN(24, dtype)
    with torch.no_grad():
        for t, s, o in ((bn.weight, 0.1, 1.0), (bn.bias, 0.1, 0.0),
                        (bn.running_mean, 0.2, 0.0), (bn.running_var, 0.3, 1.0)):
            t.copy_(torch.randn(24, generator=g).abs() * s + o if t is bn.running_var
                    else torch.randn(24, generator=g) * s + o)
    x = (torch.randn(2, 24, 7, 9, generator=g) * 3).to(dtype)
    with torch.inference_mode():
        want = bn(x)
    with torch.no_grad():
        assert torch.equal(bn(x), want)
    got = bn(x)
    assert got.requires_grad and got.dtype == dtype
    assert torch.equal(got.detach(), want)
    got.float().sum().backward()
    assert bn.weight.grad is not None and bn.bias.grad is not None
    assert bn.running_mean.grad is None


def test_remat_gradients_bit_identical():
    _, v = jax_model()
    batch = targs(make_batch(1))
    grads = []
    for remat in (False, True):
        model = port_model(v, remat=remat)
        total, _ = compute_losses(model, *batch, torch.from_numpy(ANCHORS), tcfg.ILConfig(),
                                  tcfg.FocalConfig(), LossStatics(num_classes=C))
        total.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_stem_relu_tie_gradient_is_jax_half():
    """At y == 0 exactly (a zero frame and a zero bias), the stem's ReLU
    and its pool pass the gradient as JAX's reference does (lax.max's
    0.5 at ties); torch.clamp_min would pass 1."""
    r = np.random.RandomState(2)
    x4 = np.zeros((1, 5, 6, 64), np.float32)
    x4[0, :2, :3, :48] = r.randn(2, 3, 48)       # one corner live, the rest at the tie
    k7 = (r.randn(7, 7, 3, 64) * 0.05).astype(np.float32)
    k3 = np.asarray(j_pack_stem_kernel(jnp.asarray(k7)))
    bias4 = np.zeros(256, np.float32)
    g = r.randn(1, 5, 6, 64).astype(np.float32)

    jg = jax.grad(lambda x, k, b: jnp.sum(j_stem_fused(x, k, b) * g), argnums=(0, 1, 2))(
        jnp.asarray(x4), jnp.asarray(k3), jnp.asarray(bias4))
    tx, tk, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x4, k3, bias4))
    (tsf.stem_fused(tx, tk, tb) * torch.from_numpy(g)).sum().backward()
    for got, want in zip((tx.grad, tk.grad, tb.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the clamp_min form differs there: the test would see it
    tb2 = torch.from_numpy(bias4).requires_grad_(True)
    w = torch.from_numpy(k3).permute(3, 2, 0, 1)
    y4 = torch.nn.functional.conv2d(torch.from_numpy(x4).permute(0, 3, 1, 2), w,
                                    padding=1).permute(0, 2, 3, 1) + tb2
    (phase_pool(torch.clamp_min(y4, 0)) * torch.from_numpy(g)).sum().backward()
    assert not np.allclose(tb2.grad.numpy(), np.asarray(jg[2]), rtol=1e-5, atol=1e-6)


def test_stem_trains_after_an_inference_mode_call():
    """A first packing under ``torch.inference_mode`` (a predict before
    training, in one process) must leave nothing behind that a later
    backward could not save. The packing once cached index tensors per
    device; it now slices, with no cache, and this holds it to that."""
    k7 = torch.from_numpy((np.random.RandomState(8).randn(7, 7, 3, 64) * 0.05).astype(np.float32))
    with torch.inference_mode():
        tsf.unpack_stem_kernel(tsf.pack_stem_kernel(k7))
    k = k7.clone().requires_grad_(True)
    tsf.pack_stem_kernel(k).sum().backward()
    k3 = tsf.pack_stem_kernel(k7).requires_grad_(True)
    tsf.unpack_stem_kernel(k3).sum().backward()
    assert float(k.grad.abs().sum()) > 0 and float(k3.grad.abs().sum()) > 0


def test_stem_function_runs_under_inference_mode():
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(1, 4, 5, 64).astype(np.float32))
    k3 = tsf.pack_stem_kernel(torch.from_numpy((r.randn(7, 7, 3, 64) * 0.05).astype(np.float32)))
    b = torch.from_numpy(r.randn(256).astype(np.float32))
    with torch.inference_mode():
        got = tsf.stem_fused(x, k3, b)
    assert torch.equal(got, tsf.stem_fused_reference(x, k3, b))
