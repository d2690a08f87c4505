"""The port's state-0 trainer (``train/trainer.ILTrainer``,
``train/loop.train_process``, ``cli/train.py``) against the JAX package's,
in float32 on the CPU.

One toy dataset (the port's ``make_toy_dataset``, PNG, 5 classes,
48 x 64 images, every third one portrait) trains an R18 RetinaNet with
FPN 32 and 2 head layers, B=2, in 64 x 64 frames with ``min_side`` 48
and ``max_side`` 64: every image keeps its size (scale 1), so the two
loaders give the same batches bit for bit (tests/test_torch_data.py)
and the runs differ only in the model, the loss and the optimizer. The
port's model starts from JAX's initial variables through
``models.bridge.load_jax_variables``, with a fresh optimizer.

Tolerances:
  * every micro-step's ``total_loss`` at rtol 1e-4 (the train step's
    metric bar in tests/test_torch_train_step.py);
  * parameters at that file's per-apply bar, summed over the applies:
    where JAX's first Adam moment is at least 1e-3 of the leaf's largest
    (the gradient well above the leaf's noise), the port's move within
    1e-3 lr per apply of JAX's, plus one float32 spacing of the
    parameter. With every_iter=1 this holds for the final parameters.
    With every_iter=2 it holds for the epoch-1 checkpoints (2 applies);
    at micro-step 5 the runs part in ``layer4_0`` (ROADMAP §3), so the
    final parameters are not held to the bar; at that micro-step the two
    gradients, taken at the same parameters, agree at the train step's
    gradient bar (``test_gradient_matches_jax_where_the_runs_part``), and
    the parting comes from a pre-activation that rounding puts on either
    side of a ReLU's kink (``test_runs_part_at_a_relu_kink_in_layer4_0``);
  * the default lr, 1e-5: at lr 1e-4 and every_iter=1 the same parting
    takes micro-step 7's loss past rtol 1e-4 (ROADMAP §3);
  * a killed-and-resumed port run equals an unbroken one bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.train.loop import train_process as j_train_process
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.cli.train import main as train_main
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.train.loop import train_process
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-5


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_trainer"))
    json_path = make_toy_dataset(root, num_images=8, image_size=(48, 64), seed=2)
    return json_path, os.path.join(root, "images")


def jax_cfg(tmp, every_iter=1, fused=False, end_epoch=2, start_epoch=1):
    return jcfg.TrainConfig(
        model=jcfg.ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                               compute_dtype="float32"),
        data=jcfg.DataConfig(batch_size=2, min_side=48, max_side=64, height=64, width=64,
                             max_boxes=8, num_workers=0, prefetch=0, fused_stem=fused,
                             transfer_dtype="uint8" if fused else "float32"),
        schedule=jcfg.ScheduleConfig(lr=LR, every_iter=every_iter),
        il=jcfg.ILConfig(scenario=("5",)),
        checkpoint_dir=os.path.join(tmp, "ckpt"),
        start_epoch=start_epoch, end_epoch=end_epoch, record=False,
    )


def port_cfg(jc) -> tcfg.TrainConfig:
    """The port's config of a JAX config, through its params.json text."""
    return tcfg.TrainConfig.from_json(jc.to_json())


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def jax_params(trainer) -> dict:
    """{port name: float32 numpy (OIHW)} of a JAX trainer's params."""
    return jax_to_port(trainer.train_state.params)


def port_params(trainer) -> dict:
    return {n: p.detach().cpu().numpy().copy() for n, p in trainer.model.named_parameters()}


def jax_to_port(tree) -> dict:
    """{port name: float32 numpy (OIHW)} of a JAX params-shaped tree."""
    out = {}
    for path, val in _leaves(jax.tree.map(np.asarray, tree)):
        arr = np.asarray(val, np.float32)
        out[port_name(("params",) + path)] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return out


def jax_mu(opt_state) -> dict:
    """JAX's first Adam moment of every parameter, by port name."""
    out = {}
    for masked in opt_state[0].inner_states.values():
        mu = masked.inner_state.inner_state[0].mu
        leaves = jax.tree_util.tree_flatten_with_path(
            mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for path, val in leaves:
            if not isinstance(val, optax.MaskedNode):
                arr = np.asarray(val, np.float32)
                out[port_name(("params",) + tuple(p.key for p in path))] = (
                    arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr)
    return out


def run_pair(toy, tmp_path, **kw):
    """(JAX trainer, port trainer, port initial params) after two epochs
    from the same initial variables."""
    json_path, images = toy
    jc = jax_cfg(str(tmp_path / "jax"), **kw)
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp_path / "jax"))
    pt = ILTrainer(port_cfg(jc).replace(checkpoint_dir=str(tmp_path / "port" / "ckpt")),
                   json_path, images, workdir=str(tmp_path / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    init = port_params(pt)
    j_train_process(jt)
    train_process(pt)
    return jt, pt, init


def assert_losses_close(pt, jt):
    got, want = list(pt.loss_hist), list(jt.loss_hist)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g)
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"micro-step {i}")


def assert_params_close(got: dict, want: dict, init: dict, applies: int, mu: dict):
    """The module docstring's parameter bar; ``mu`` is JAX's first Adam
    moment at the same point."""
    assert set(got) == set(want)
    for name, w in want.items():
        d_port, d_jax = got[name] - init[name], w - init[name]
        ulp = np.spacing(np.abs(init[name]))
        assert np.isfinite(d_port).all(), name
        m = np.abs(mu[name])
        sel = m >= 1e-3 * m.max() if m.max() > 0 else np.zeros_like(m, bool)
        bad = sel & (np.abs(d_port - d_jax) > 1e-3 * LR * applies + ulp)
        assert not bad.any(), (f"{name}: {int(bad.sum())} of {int(sel.sum())} elements "
                               f"off, max {np.abs(d_port - d_jax)[bad].max():.3g}")


@pytest.mark.parametrize("every_iter", [1, 2])
def test_train_process_matches_jax(toy, tmp_path, every_iter):
    """Two epochs of train_process, RGB frames: per-micro-step total_loss,
    the epoch-1 checkpoints' parameters and, with every_iter=1, the final
    parameters against JAX's trainer (module docstring); checkpoints and
    the loss windows."""
    jt, pt, init = run_pair(toy, tmp_path, every_iter=every_iter)
    assert_losses_close(pt, jt)
    assert pt.train_state.step == len(pt.loss_hist) == 8
    target = {"params": jt.train_state.params, "batch_stats": jt.train_state.batch_stats,
              "opt_state": jt.train_state.opt_state, "step": jt.train_state.step}
    jtree, _ = jt.ckpt.restore(0, 1, target=target)
    ptree, meta1 = pt.ckpt.restore(0, 1)
    got1 = {k: v.numpy() for k, v in ptree["model"].items() if k in init}
    assert_params_close(got1, jax_to_port(jtree["params"]), init, 4 // every_iter,
                        jax_mu(jtree["opt_state"]))
    if every_iter == 1:
        assert_params_close(port_params(pt), jax_params(jt), init, 8,
                            jax_mu(jt.train_state.opt_state))
    assert pt.ckpt.epochs(0) == jt.ckpt.epochs(0) == [1, 2]
    assert meta1["loss_hist"] == list(pt.loss_hist)[:4]
    assert [r["epoch"] for r in pt.epoch_log] == [1, 2]
    assert all(r["micro_steps"] == 4 and r["images"] == 8 for r in pt.epoch_log)


def test_train_process_fused_uint8_matches_jax(toy, tmp_path):
    """The 4x4 space-to-depth uint8 frames (the fused stem's plain
    version on the CPU), every_iter=1: losses and final parameters, the
    stem's included."""
    jt, pt, init = run_pair(toy, tmp_path, every_iter=1, fused=True)
    assert_losses_close(pt, jt)
    assert_params_close(port_params(pt), jax_params(jt), init, 8,
                        jax_mu(jt.train_state.opt_state))


def test_gradient_matches_jax_where_the_runs_part(toy, tmp_path):
    """The port's trainer after micro-steps 0-4 (every_iter=2); at its
    parameters, the gradient of micro-step 5's batch against JAX's
    jitted ``value_and_grad`` of ``compute_losses`` at the same
    parameters: the train step's gradient bar, |d| <= 1e-3 |g_jax| +
    1e-4 max|g_jax| per leaf, and the metrics at rtol 1e-4."""
    import jax.numpy as jnp

    from cl_object_detection_tpu.il.losses import LossStatics as JLossStatics
    from cl_object_detection_tpu.il.losses import compute_losses as j_compute_losses
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses

    json_path, images = toy
    jc = jax_cfg(str(tmp_path / "jax"), every_iter=2)
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp_path / "jax"))
    pt = ILTrainer(port_cfg(jc).replace(checkpoint_dir=str(tmp_path / "port" / "ckpt")),
                   json_path, images, workdir=str(tmp_path / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    batches = []
    for epoch in (1, 2):
        pt.train_loader.set_epoch(epoch)
        batches += list(pt.train_loader)
    for b in batches[:5]:
        pt.run_batch(b)
    assert pt.train_state.acc_count == 1
    pt.model.zero_grad(set_to_none=True)
    b = batches[5]
    anchors = pt._anchors_at(64, 64)
    total, metrics = compute_losses(pt.model, *(torch.from_numpy(a) for a in (b.images, b.boxes, b.labels)),
                                    torch.from_numpy(anchors.copy()), tcfg.ILConfig(),
                                    tcfg.FocalConfig(), LossStatics(num_classes=5))
    total.backward()

    def to_jax(tree):
        def leaf(path, x):
            arr = pt.model.get_parameter(port_name(("params",) + tuple(p.key for p in path)))
            arr = arr.detach().numpy()
            return jnp.asarray(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr)
        return jax.tree_util.tree_map_with_path(leaf, tree)

    def loss_fn(params, x, boxes, labels):
        return j_compute_losses(
            lambda v, xx, act: jt.model.apply(v, xx, enable_act=act), None,
            {"params": params, "batch_stats": jt.train_state.batch_stats}, x, boxes, labels,
            jnp.asarray(anchors), jcfg.ILConfig(), jcfg.FocalConfig(), JLossStatics(num_classes=5))

    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(jt.train_state.params), *(jnp.asarray(a) for a in (b.images, b.boxes, b.labels)))
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    want = jax_to_port(jgrads)
    for name, p in pt.model.named_parameters():
        g, w = p.grad.numpy(), want[name]
        assert (np.abs(g - w) <= 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all(), name


def _parted(got: dict, want: dict, init: dict, applies: int, mu: dict) -> set:
    """Names of the parameters beyond ``assert_params_close``'s bar."""
    out = set()
    for name, w in want.items():
        m = np.abs(mu[name])
        sel = m >= 1e-3 * m.max() if m.max() > 0 else np.zeros_like(m, bool)
        d = np.abs((got[name] - init[name]) - (w - init[name]))
        if (sel & (d > 1e-3 * LR * applies + np.spacing(np.abs(init[name])))).any():
            out.add(name)
    return out


def test_runs_part_at_a_relu_kink_in_layer4_0(toy, tmp_path):
    """Why the runs part at micro-step 5 (every_iter=2; ROADMAP §3): after
    micro-steps 0-3 each package's parameters differ from the other's by
    float32 rounding (no parameter beyond the bar), and on a batch of the
    next apply (micro-steps 4 and 5) a pre-activation of ``layer4_0``
    (its first ReLU's input ``bn1``, or its output ReLU's input ``bn2 +
    downsample_bn``) lies within that rounding of the kink at 0: on the
    positive side in one run and the other side in the other. The ReLU
    passes that element's gradient in one run only, so after the apply
    the parameters part, and only those upstream of ``layer4_0``'s output
    (the stem, layer1-3 and layer4_0 itself; layer4_1, the FPN and the
    heads stay within the bar). On this repo's CPU runs the element is
    micro-step 4's output pre-activation at (image 0, channel 358, 1, 1):
    port +2.6e-6, JAX -1.1e-6, the runs differing by at most 1.1e-5
    over the block, whose values reach 12."""
    json_path, images = toy
    jc = jax_cfg(str(tmp_path / "jax"), every_iter=2)
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp_path / "jax"))
    pt = ILTrainer(port_cfg(jc).replace(checkpoint_dir=str(tmp_path / "port" / "ckpt")),
                   json_path, images, workdir=str(tmp_path / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    init = port_params(pt)
    batches = []
    for epoch in (1, 2):
        pt.train_loader.set_epoch(epoch)
        batches += list(pt.train_loader)
    for b in batches[:4]:
        pt.run_batch(b)
        jt.run_batch(b)
    assert not _parted(port_params(pt), jax_params(jt), init, 2,
                       jax_mu(jt.train_state.opt_state))
    block = pt.model.backbone.layer4_0

    def port_pre(x):
        seen = {}
        hooks = [getattr(block, n).register_forward_hook(
            lambda m, a, o, n=n: seen.__setitem__(n, o.detach().numpy()))
            for n in ("bn1", "bn2", "downsample_bn")]
        with torch.no_grad():
            pt.model(torch.from_numpy(x), enable_act=False)
        for h in hooks:
            h.remove()
        return {"relu1": seen["bn1"], "out": seen["bn2"] + seen["downsample_bn"]}

    def jax_pre(x):
        import jax.numpy as jnp

        _, st = jt.model.apply(jt.train_state.variables, jnp.asarray(x), enable_act=False,
                               capture_intermediates=True, mutable=["intermediates"])
        blk = st["intermediates"]["backbone"]["layer4_0"]
        nchw = {n: np.asarray(blk[n]["__call__"][0]).transpose(0, 3, 1, 2)
                for n in ("bn1", "bn2", "downsample_bn")}
        return {"relu1": nchw["bn1"], "out": nchw["bn2"] + nchw["downsample_bn"]}

    flips = []
    for i in (4, 5):
        got, want = port_pre(batches[i].images), jax_pre(batches[i].images)
        for kind in ("relu1", "out"):
            g, w = got[kind], want[kind]
            assert g.shape == (2, 512, 2, 2)
            diff = np.abs(g - w).max()
            # the runs differ by float32 rounding: a few spacings of the
            # block's largest value
            assert diff <= 2e-6 * np.abs(w).max(), (i, kind, diff)
            for idx in zip(*np.where((g > 0) != (w > 0))):
                flips.append((i, kind, tuple(int(v) for v in idx), float(g[idx]),
                              float(w[idx]), float(diff)))
    assert flips, "no pre-activation of layer4_0 straddles the kink"
    for i, kind, idx, g, w, diff in flips:
        # within the runs' rounding of the kink on both sides
        assert abs(g) <= diff and abs(w) <= diff, flips

    for b in batches[4:6]:
        pt.run_batch(b)
        jt.run_batch(b)
    parted = _parted(port_params(pt), jax_params(jt), init, 3, jax_mu(jt.train_state.opt_state))
    upstream = {n for n in init if n.startswith("backbone.")
                and not n.startswith("backbone.layer4_1.")}
    assert parted, "the runs did not part after the apply of micro-step 5"
    assert parted <= upstream, sorted(parted - upstream)
    if any(kind == "out" for _, kind, *_ in flips):
        # the output ReLU's gate moves the gradients of both its branches
        assert {"backbone.layer4_0.conv2.weight",
                "backbone.layer4_0.downsample_conv.weight"} <= parted, sorted(parted)


def test_crash_resume_is_bitwise(toy, tmp_path):
    """Run A trains epochs 1..4 straight; run B trains 1..2, stops, and a
    fresh trainer resumes from the epoch-2 checkpoint (weights, Adam
    state, micro-step count, loss window; data order from the epoch-pinned
    loader) for 3..4. Parameters equal bit for bit, and the loss windows."""
    json_path, images = toy
    # checkpoints only where the test reads them (epoch 2 of run B)
    cfg_a = port_cfg(jax_cfg(str(tmp_path / "a"), every_iter=2, end_epoch=4)).replace(
        save_every=4)
    tr_a = ILTrainer(cfg_a, json_path, images, workdir=str(tmp_path / "a"), device="cpu")
    train_process(tr_a)

    cfg_b = port_cfg(jax_cfg(str(tmp_path / "b"), every_iter=2, end_epoch=2)).replace(
        save_every=2)
    tr_b = ILTrainer(cfg_b, json_path, images, workdir=str(tmp_path / "b"), device="cpu")
    train_process(tr_b)
    hist_b = list(tr_b.loss_hist)
    del tr_b

    cfg_b2 = cfg_b.replace(start_epoch=3, end_epoch=4)
    tr_b2 = ILTrainer(cfg_b2, json_path, images, workdir=str(tmp_path / "b"), device="cpu")
    assert tr_b2.resume(0, 2) == 2
    assert list(tr_b2.loss_hist) == hist_b
    assert tr_b2.train_state.step == 8
    train_process(tr_b2)
    a, b = tr_a.model.state_dict(), tr_b2.model.state_dict()
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    oa, ob = tr_a.optimizer.state_dict(), tr_b2.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for k in oa["state"]:
        for m in ("mu", "nu"):
            assert torch.equal(oa["state"][k][m], ob["state"][k][m])
    assert list(tr_a.loss_hist) == list(tr_b2.loss_hist)


def test_resume_restores_every_piece_of_state(toy, tmp_path):
    """resume() after a schedule and beta change: the LR and betas of both
    groups, the counts, the moments, the frozen-BN buffers."""
    json_path, images = toy
    cfg = port_cfg(jax_cfg(str(tmp_path), end_epoch=1)).replace(
        schedule=tcfg.ScheduleConfig(lr=LR, every_iter=1, scheduler_milestone=(0,),
                                     classifier_lr_scale=10.0))
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp_path), device="cpu")
    with torch.no_grad():
        tr.model.backbone.bn1.running_var.mul_(1.5)
    train_process(tr)
    saved_model = {k: v.clone() for k, v in tr.model.state_dict().items()}
    saved_opt = tr.optimizer.state_dict()
    assert [g["lr"] for g in saved_opt["param_groups"]] == pytest.approx([LR * 0.1, LR])

    fresh = ILTrainer(cfg, json_path, images, workdir=str(tmp_path), device="cpu")
    fresh.resume(0, 1)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved_model[k]), k
    got = fresh.optimizer.state_dict()
    assert got["param_groups"] == saved_opt["param_groups"]
    assert all(g["count"] == 4 for g in got["param_groups"])
    for k, st in saved_opt["state"].items():
        for m in ("mu", "nu"):
            assert torch.equal(got["state"][k][m], st[m])


def test_warm_stage_matches_jax(toy, tmp_path):
    """warm_stage 1 ('output' only for 1 epoch, then everything): the
    masked first epoch and the unmasked second, against JAX."""
    json_path, images = toy
    jc = jax_cfg(str(tmp_path / "jax")).replace(
        warmup=jcfg.WarmupConfig(warm_stage=1, warm_epoch=(1,), warm_layers=("output",)))
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp_path / "jax"))
    pt = ILTrainer(port_cfg(jc).replace(checkpoint_dir=str(tmp_path / "port" / "ckpt")),
                   json_path, images, workdir=str(tmp_path / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    init = port_params(pt)
    pt.warm_up(1)
    assert pt._warm_kind == "output"
    pt.warm_up(2)
    assert pt._warm_kind is None
    j_train_process(jt)
    train_process(pt)
    assert_losses_close(pt, jt)
    assert_params_close(port_params(pt), jax_params(jt), init, 8,
                        jax_mu(jt.train_state.opt_state))


# --------------------------------------------------------------------- CLI

CLI_ARGS = ["--scenario", "5", "--end_epoch", "2", "--depth", "18", "--image_height", "64",
            "--image_width", "64", "--batch_size", "2", "--every_iter", "1",
            "--record", "false", "--print_il_info", "false"]


def _cli(toy, root, *extra):
    json_path, images = toy
    return ["--root_dir", root, "--train_json", json_path, "--image_dir", images,
            *CLI_ARGS, *extra]


def test_train_cli_writes_checkpoints_and_params(toy, tmp_path):
    """cli.train --cpu trains, writes params.json (which JAX's TrainConfig
    reads) and a checkpoint per epoch; --start_epoch 2 resumes epoch 1."""
    root = str(tmp_path)
    trainer = train_main(_cli(toy, root, "--cpu"))
    state_dir = os.path.join(root, "checkpoint", "5", "state0")
    with open(os.path.join(state_dir, "params.json")) as f:
        text = f.read()
    cfg = json.loads(text)
    assert cfg["model"]["depth"] == 18 and cfg["data"]["height"] == 64
    assert jcfg.TrainConfig.from_json(text).to_json() == text
    assert trainer.ckpt.epochs(0) == [1, 2]
    assert trainer.device.type == "cpu"
    resumed = train_main(_cli(toy, root, "--cpu", "--start_epoch", "2"))
    assert resumed.train_state.step == 8           # 4 restored + 4 trained
    assert [r["epoch"] for r in resumed.epoch_log] == [2]


def test_train_cli_without_cpu_or_cuda_raises(toy, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(_cli(toy, str(tmp_path)))
    assert not os.path.exists(os.path.join(str(tmp_path), "checkpoint"))


_STATE1 = ["--scenario", "3", "2", "--end_state", "1", "--end_epoch", "1",
           "--new_state_epoch", "1"]


@pytest.mark.parametrize("flags,item", [
    pytest.param(_STATE1 + ["--agem", "true", "--sample_num", "1", "--sample_method",
                            "random"], None, id="flags0-item 4c"),
    pytest.param(_STATE1 + ["--mas", "true"], None, id="flags1-item 4c"),
    pytest.param(["--mesh", "true"], "one rank", id="flags2-item 6"),
    pytest.param(["--mesh", "true", "--zero1", "true"], "one rank", id="flags3-item 6"),
    pytest.param(["--mesh", "true", "--num_data", "2"], "two ranks", id="flags4-item 6"),
    pytest.param(["--coordinator_address", "localhost:1234", "--num_processes", "1",
                  "--process_id", "0"], "one rank", id="flags5-item 6"),
    pytest.param(["--num_model", "2"], "no mesh", id="flags6-item 6b"),
])
def test_train_cli_refuses_what_is_not_ported(toy, tmp_path, flags, item):
    """The model axis (item 6b, once refused here) runs: without ``--mesh``
    ``--num_model`` is ignored, as JAX's disabled mesh ignores it, and one
    process trains (two ranks of it: tests/test_torch_model_axis.py and
    ``--mesh true --num_model 2`` in the card tests). The data axis
    (item 6a, once refused here) trains: ``--mesh true`` on the CPU, and
    the process flags of one process, on a one-rank mesh, where ZeRO-1
    (item 6b-i, once refused here) is a no-op (no moment is split);
    ``--mesh true --num_data 2`` starts two CPU ranks, which write one
    checkpoint per epoch (``main`` returns None in the process that started
    them). A-GEM and MAS (item 4c, once refused here) train state 0 and
    then state 1, whose checkpoint is written."""
    if item == "no mesh":
        trainer = train_main(_cli(toy, str(tmp_path), "--cpu", *flags))
        assert trainer.mesh is None and not trainer.optimizer.sharded
        assert trainer.ckpt.epochs(0) == [1, 2] and len(trainer.loss_hist) == 8
        return
    if item == "one rank":
        trainer = train_main(_cli(toy, str(tmp_path), "--cpu", *flags))
        assert trainer.mesh.shape == {"data": 1, "model": 1} and trainer.mesh.backend is None
        assert not trainer.mesh.zero1 and not trainer.optimizer.sharded
        assert trainer.ckpt.epochs(0) == [1, 2] and len(trainer.loss_hist) == 8
        return
    if item == "two ranks":
        assert train_main(_cli(toy, str(tmp_path), "--cpu", *flags)) is None
        state_dir = os.path.join(str(tmp_path), "checkpoint", "5", "state0")
        assert sorted(os.listdir(state_dir)) == ["epoch1", "epoch2", "params.json"]
        tree = torch.load(os.path.join(state_dir, "epoch2", "state.pt"), weights_only=True)
        assert tree["step"] == 8                      # 4 global batches of 2 a epoch
        assert all(torch.isfinite(v).all() for v in tree["model"].values())
        return
    if item is None:
        try:
            trainer = train_main(_cli(toy, str(tmp_path), "--cpu", *flags))
            assert trainer.cur_state == 1 and trainer.ckpt.epochs(1) == [1]
            assert trainer.agem is not None or trainer.mas_importance is not None
        finally:       # two states of R18 checkpoints, ~300 MB
            shutil.rmtree(tmp_path, ignore_errors=True)
        return
    raise AssertionError(f"no case {item}")


def test_trainer_refuses_states_and_mesh(toy, tmp_path):
    """The mesh (item 6a, once refused here) builds a one-rank data axis
    without a process group, where ZeRO-1 (item 6b-i, once refused here)
    is a no-op; the model axis (item 6b, once refused here) takes JAX's
    check that ``num_data x num_model`` equals the devices: one rank
    cannot hold a model axis of two.
    BiC and A-GEM (items
    4d and 4c, once refused here) build their tools at a state-1 start
    with replay: BiC's held-out loader and scalars, A-GEM over the replay
    loader; without replay each raises as JAX's trainer does."""
    json_path, images = toy
    base = port_cfg(jax_cfg(str(tmp_path)))
    replay = tcfg.ReplayConfig(sample_num=1, sample_method="random")
    bic_cfg = base.replace(il=tcfg.ILConfig(scenario=("3", "2"), start_state=1, replay=replay,
                                            bic=tcfg.BiCConfig(enabled=True)))
    tr = ILTrainer(bic_cfg, json_path, images, workdir=str(tmp_path), device="cpu")
    assert tr.bic is not None and tr.bic.cur_state == 1 and len(tr.bic.bic_loader) > 0
    agem_cfg = base.replace(il=tcfg.ILConfig(scenario=("3", "2"), start_state=1, end_state=1,
                                             replay=replay, agem=tcfg.AGEMConfig(enabled=True)))
    tr = ILTrainer(agem_cfg, json_path, images, workdir=str(tmp_path), device="cpu")
    assert tr.agem is not None and tr.agem.replay_loader is tr.replay_loader
    for cfg in (bic_cfg, agem_cfg):
        no_replay = cfg.replace(il=dataclasses.replace(cfg.il, replay=tcfg.ReplayConfig()))
        with pytest.raises(ValueError, match="requires"):
            ILTrainer(no_replay, json_path, images, workdir=str(tmp_path), device="cpu")
    tr = ILTrainer(base.replace(mesh=tcfg.MeshConfig(enabled=True)), json_path, images,
                   workdir=str(tmp_path), device="cpu")
    assert (tr.mesh.rank, tr.mesh.world, tr.primary) == (0, 1, True)
    assert tr.train_loader.process_count == 1
    tr = ILTrainer(base.replace(mesh=tcfg.MeshConfig(enabled=True, zero1=True)), json_path,
                   images, workdir=str(tmp_path), device="cpu")
    assert not tr.mesh.zero1 and not tr.optimizer.sharded
    with pytest.raises(ValueError, match="mesh 0x2 != 1 devices"):
        ILTrainer(base.replace(mesh=tcfg.MeshConfig(enabled=True, num_model=2)), json_path,
                  images, workdir=str(tmp_path), device="cpu")


def test_train_cli_as_a_module(toy, tmp_path):
    """``python -m cl_object_detection_tpu_torch.cli.train --cpu`` in a
    fresh process: trains one epoch and imports no JAX."""
    probe = ("import runpy, sys; sys.argv = ['train'] + sys.argv[1:]; "
             "runpy.run_module('cl_object_detection_tpu_torch.cli.train', run_name='__main__'); "
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'flax', 'optax', 'orbax', 'cl_object_detection_tpu')]; "
             "assert not bad, bad")
    args = _cli(toy, str(tmp_path), "--cpu")
    args[args.index("--end_epoch") + 1] = "1"
    # the process takes this one's torch threads: more would oversubscribe the
    # cores that the suite's other workers use
    out = subprocess.run([sys.executable, "-c", probe, *args], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS=str(torch.get_num_threads())),
                         capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Epoch 1 done" in out.stdout
    assert os.path.isdir(os.path.join(str(tmp_path), "checkpoint", "5", "state0", "epoch1"))
