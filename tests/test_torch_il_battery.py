"""The whole IL battery through the port's trainer over three states, on
the CPU in float32: distillation, random replay, MAS, A-GEM, BiC and
pseudo-labels at once (JAX's tests/test_multistate.py scenario), and a
three-state run held against JAX's trainer.

Models: R18 (the full-battery mirror with JAX's own widths and frames;
the parity run at FPN 32, 2 head layers, 128 x 128 frames over 96 x 96
PNG images, scale 1, so both packages' loaders give the same batches).

Tolerances (tests/test_torch_trainer.py's bars): every micro-step's
total_loss at rtol 1e-4, lr 1e-5; the BiC scalars of each state at rtol
1e-4. The parity run keeps pseudo-labels off: two runs whose models Adam
has moved apart by ~4e-5 pick other pseudo-labels near the score
threshold (ROADMAP §3 watch-list); the full-battery mirror runs them in
the port alone.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.train.loop import train_process as j_train_process
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables
from cl_object_detection_tpu_torch.train.loop import train_process
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy_battery(tmp_path_factory):
    """JAX's full-battery toy set: 15 images, seed 11."""
    root = str(tmp_path_factory.mktemp("toy_3state"))
    make_toy_dataset(root, num_images=15, seed=11, split="train")
    return root


@pytest.fixture
def run_dir(tmp_path):
    """``tmp_path``, emptied after the test (three states of R18
    checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_three_state_full_battery(toy_battery, run_dir):
    """JAX's test_three_state_full_battery through the port: scenario
    2+2+1 with BiC, A-GEM (refresh every 4), random replay, distillation,
    MAS and pseudo-labels. BiC is rebuilt for state 2 with the state-1
    alpha carried over and the state-2 alpha trained; the replay gradient
    has the expanded classifier's 9 x 5 output channels; ``mas_loss`` is
    in every new-image micro-step of states 1 and 2, every loss finite;
    the state-2 checkpoint carries the trainer's BiC scalars."""
    toy = toy_battery
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(depth=18, compute_dtype="float32"),
        data=tcfg.DataConfig(batch_size=2, min_side=100, max_side=192, height=128,
                             width=192, max_boxes=8, num_workers=0, prefetch=0),
        schedule=tcfg.ScheduleConfig(lr=1e-4, every_iter=1, new_state_epoch=1),
        il=tcfg.ILConfig(
            scenario=("2", "2", "1"), end_state=2,
            distill=tcfg.DistillConfig(enabled=True),
            replay=tcfg.ReplayConfig(sample_num=2, sample_method="random"),
            mas=tcfg.MASConfig(enabled=True, ratio=0.5),
            agem=tcfg.AGEMConfig(enabled=True, refresh_every=4),
            bic=tcfg.BiCConfig(enabled=True, ratio=0.4),
            pseudo=tcfg.PseudoLabelConfig(enabled=True, score_thresh=0.2),
        ),
        checkpoint_dir=os.path.join(str(run_dir), "ckpt"),
        start_epoch=1, end_epoch=1, record=False,
    )
    trainer = ILTrainer(cfg, os.path.join(toy, "train.json"), os.path.join(toy, "images"),
                        workdir=str(run_dir), device="cpu")
    a_after_1 = {}
    steps = []
    orig_next, orig_run = trainer.next_state, trainer.run_batch

    def capture_next():
        if trainer.bic is not None and trainer.cur_state == 1:
            a_after_1["alphas"] = trainer.bic.params.alphas.clone()
        orig_next()

    def run_batch(batch, is_replay=False, sync_metrics=True, correction=False):
        m = orig_run(batch, is_replay=is_replay, sync_metrics=True, correction=correction)
        steps.append((trainer.cur_state, is_replay, m))
        return m

    trainer.next_state, trainer.run_batch = capture_next, run_batch
    train_process(trainer)

    assert trainer.cur_state == 2
    assert trainer.num_classes == 5
    assert trainer.bic is not None and trainer.bic.cur_state == 2
    alphas = trainer.bic.params.alphas.numpy()
    np.testing.assert_allclose(alphas[0], a_after_1["alphas"][0].numpy())
    assert a_after_1["alphas"][0] != pytest.approx(1.0)
    assert alphas[1] != pytest.approx(1.0)
    assert trainer.agem is not None and trainer.agem.replay_grad is not None
    k = trainer.agem.replay_grad["classification_head.output.weight"]
    assert k.shape[0] == 9 * 5
    later = [m for st, r, m in steps if st >= 1 and not r]
    assert later and all("mas_loss" in m and np.isfinite(m["mas_loss"]) for m in later)
    assert {st for st, _, _ in steps} == {0, 1, 2}
    assert np.isfinite([m["total_loss"] for _, _, m in steps]).all()
    meta = trainer.ckpt.restore(2, 1)[1]
    assert meta["bic"] == {"alphas": trainer.bic.params.alphas.tolist(),
                           "betas": trainer.bic.params.betas.tolist()}
    for state in (0, 1):
        assert os.path.exists(os.path.join(trainer.ckpt.state_dir(state), "mas_importance.npz"))


CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
DATA = dict(batch_size=2, min_side=96, max_side=96, height=128, width=128, max_boxes=8,
            num_workers=0, prefetch=0)
SIM = np.array([[0.6, 0.4], [0.2, 0.8]], np.float32)


@pytest.fixture(scope="module")
def toy_parity(tmp_path_factory):
    """24 PNG images at 96 x 96, 5 classes."""
    root = str(tmp_path_factory.mktemp("toy_battery_parity"))
    json_path = make_toy_dataset(root, num_images=24, image_size=(96, 96), seed=5)
    return json_path, os.path.join(root, "images")


def test_three_state_battery_matches_jax(toy_parity, run_dir):
    """Scenario 2+2+1 with distillation, random replay (2 per old class),
    MAS, A-GEM (refresh every 2) and BiC, pseudo-labels off, from the same
    initial weights as JAX's trainer: every micro-step's total_loss at
    rtol 1e-4, the same replay and BiC held-out ids at each state, the
    trained BiC scalars of states 1 and 2 and each checkpoint's
    ``il_meta["bic"]`` at rtol 1e-4."""
    json_path, images = toy_parity
    il = dict(distill=jcfg.DistillConfig(enabled=True),
              replay=jcfg.ReplayConfig(sample_num=2, sample_method="random",
                                       sample_batch_size=2),
              mas=jcfg.MASConfig(enabled=True, ratio=0.5),
              agem=jcfg.AGEMConfig(enabled=True, refresh_every=2),
              bic=jcfg.BiCConfig(enabled=True, ratio=0.4))
    jc = jcfg.TrainConfig(
        model=jcfg.ModelConfig(**CFG), data=jcfg.DataConfig(**DATA),
        schedule=jcfg.ScheduleConfig(lr=1e-5, every_iter=1, new_state_epoch=1),
        il=jcfg.ILConfig(scenario=("2", "2", "1"), end_state=2, init_method="mean", **il),
        checkpoint_dir=str(run_dir / "jax" / "ckpt"), start_epoch=1, end_epoch=1,
        save_every=1, record=False)
    jt = JILTrainer(jc, json_path, images, workdir=str(run_dir / "jax"))
    pc = tcfg.TrainConfig.from_json(jc.to_json()).replace(
        checkpoint_dir=str(run_dir / "port" / "ckpt"))
    pt = ILTrainer(pc, json_path, images, workdir=str(run_dir / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    jt.ckpt.save_array_sidecar(0, "similarity", [SIM])
    pt.ckpt.save_array_sidecar(0, "similarity", {"[0]": SIM})
    held_out = {}
    for tr, key in ((jt, "jax"), (pt, "port")):
        real = tr._init_bic

        def init_bic(tr=tr, key=key, real=real):
            real()
            held_out.setdefault(key, []).append(
                (list(tr.bic.bic_loader.dataset.image_ids), list(tr.dataset_replay.image_ids),
                 list(tr.dataset_train.image_ids)))

        tr._init_bic = init_bic
    j_train_process(jt)
    train_process(pt)

    got, want = list(pt.loss_hist), list(jt.loss_hist)
    assert len(got) == len(want) and len(got) >= 3 * 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g)
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"micro-step {i}")
    assert len(held_out["port"]) == 2 and held_out["port"] == held_out["jax"]
    assert all(ids[0] for ids in held_out["port"])
    for what in ("alphas", "betas"):
        np.testing.assert_allclose(getattr(pt.bic.params, what).numpy(),
                                   np.asarray(getattr(jt.bic.params, what)), rtol=1e-4)
    assert pt.bic.params.alphas[1] != 1.0
    for state in (1, 2):
        with open(os.path.join(jt.ckpt.epoch_dir(state, 1), "il_meta.json")) as f:
            jmeta = json.load(f)
        meta = pt.ckpt.restore(state, 1)[1]
        for what in ("alphas", "betas"):
            np.testing.assert_allclose(meta["bic"][what], jmeta["bic"][what], rtol=1e-4)
    assert pt.ckpt.restore(1, 1)[1]["bic"]["alphas"][1] == 1.0   # state 2's slot untrained
