"""The port's trainer on the mesh's data axis, on the CPU: JAX's
tests/test_mesh_train.py mirrored, with the port's own single-process run
as the reference (under JAX's mesh a run equals the single-device run up
to reduction order; the port's ranks compute the same global batch).

Two gloo ranks (``tests/torch_mesh_worker.py``) train R18 (FPN 32, 2 head
layers, float32) at 128 x 192 frames on 16 toy images; the parameters
after the run hold against one process's at JAX's bar (rtol 2e-3, atol
2e-5), and the two ranks' against each other bit for bit:
  * state 0 for two epochs (every_iter 2);
  * the batch-divisibility errors;
  * the incremental distillation step (JAX's
    test_mesh_incremental_distill_step);
  * two states with MAS, A-GEM, BiC, random replay and distillation: the
    exemplar ids equal, the BiC scalars at the same bar, and then
    ``cli.validate --mesh --bic true`` of its state-1 checkpoint on two
    ranks against one process (the detection bar: labels equal, boxes
    and scores at rtol 1e-4), in one test;
  * a two-process ``cli.train`` started with ``--coordinator_address`` (a
    ``file://`` store), ``--num_processes`` and ``--process_id`` (and
    ``--val true``, so that both processes read the checkpoint) against one
    process.
"""
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.cli import common, validate
from cl_object_detection_tpu_torch.train.loop import train_process
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import REPO, run_ranks  # noqa: E402

torch.set_num_threads(2)

MODEL = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
RTOL, ATOL = 2e-3, 2e-5


def mesh_cfg(ckpt, scenario, mesh, *, batch_size=4, end_epoch=2, end_state=None, **il):
    return tcfg.TrainConfig(
        model=tcfg.ModelConfig(**MODEL),
        data=tcfg.DataConfig(batch_size=batch_size, min_side=100, max_side=192, height=128,
                             width=192, max_boxes=8, num_workers=0, prefetch=0),
        schedule=tcfg.ScheduleConfig(lr=1e-4, every_iter=2, new_state_epoch=end_epoch),
        il=tcfg.ILConfig(scenario=tuple(scenario), end_state=end_state, **il),
        mesh=mesh, checkpoint_dir=ckpt, start_epoch=1, end_epoch=end_epoch, record=False)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_mesh_train"))
    make_toy_dataset(root, num_images=16, seed=3, image_size=(48, 64))
    make_toy_dataset(root, num_images=8, seed=4, image_size=(48, 64), split="test")
    return root


def _paths(toy):
    return os.path.join(toy, "train.json"), os.path.join(toy, "images")


def single(cfg, toy, workdir):
    tr = ILTrainer(cfg, *_paths(toy), workdir=workdir, device="cpu")
    train_process(tr)
    return tr


def on_ranks(tmp, cfg, toy, workdir, **extra):
    json_path, images = _paths(toy)
    return run_ranks(str(tmp), "train", dict(cfg=cfg, json=json_path, images=images,
                                             workdir=workdir, **extra))


def assert_params_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def assert_ranks_agree(ranks):
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k


def test_dp2_matches_single_process(toy, tmp_path):
    """Two epochs of state 0: two ranks == one process at JAX's bar; the
    loss window holds the global losses; only rank 0 wrote."""
    tmp = str(tmp_path)
    one = single(mesh_cfg(os.path.join(tmp, "one"), ["5"], tcfg.MeshConfig()), toy,
                 os.path.join(tmp, "one"))
    ranks = on_ranks(tmp_path / "w", mesh_cfg(os.path.join(tmp, "dp"), ["5"],
                                              tcfg.MeshConfig(enabled=True)),
                     toy, os.path.join(tmp, "dp"))
    assert_ranks_agree(ranks)
    assert_params_close(ranks[0]["params"], one.model.state_dict())
    np.testing.assert_allclose(ranks[0]["loss_hist"], list(one.loss_hist), rtol=1e-4)
    assert ranks[0]["loss_hist"] == ranks[1]["loss_hist"]
    assert ranks[0]["epochs"] == [(0, 1), (0, 2)]
    assert "5/state0/epoch2/state.pt" in ranks[0]["files"]
    assert ranks[0]["files"] == ranks[1]["files"]          # one directory, rank 0's


def test_mesh_batch_divisibility_validated(toy, tmp_path):
    """batch_size 3 and a replay sample_batch_size 5 on two ranks raise on
    both, before any collective."""
    tmp = str(tmp_path)
    bad_batch = mesh_cfg(tmp, ["5"], tcfg.MeshConfig(enabled=True), batch_size=3)
    bad_replay = mesh_cfg(tmp, ["5"], tcfg.MeshConfig(enabled=True),
                          replay=tcfg.ReplayConfig(sample_num=1, sample_batch_size=5))
    for i, cfg in enumerate((bad_batch, bad_replay)):
        ranks = on_ranks(tmp_path / f"w{i}", cfg, toy, tmp, expect=True)
        assert all("not divisible" in r["error"] for r in ranks), ranks


def test_mesh_incremental_distill_step(toy, tmp_path):
    """JAX's test_mesh_incremental_distill_step: state 0 in the classifier
    warm stage with accumulation, then state 1 from its checkpoint with
    distillation; finite losses with ``dist_feat_loss``, the ranks
    bit-identical, and the parameters equal to one process's."""
    def cfgs(root, mesh):
        cfg0 = mesh_cfg(os.path.join(root, "ck"), ["3", "2"], mesh, end_state=0, end_epoch=1)
        cfg0 = cfg0.replace(warmup=tcfg.WarmupConfig(warm_stage=1, warm_epoch=(2,),
                                                     warm_layers=("output",)))
        cfg1 = mesh_cfg(os.path.join(root, "ck"), ["3", "2"], mesh, end_state=1, end_epoch=1,
                        start_state=1, distill=tcfg.DistillConfig(enabled=True))
        return cfg0, cfg1

    json_path, images = _paths(toy)
    tmp = str(tmp_path)
    cfg0, cfg1 = cfgs(os.path.join(tmp, "dp"), tcfg.MeshConfig(enabled=True))
    ranks = run_ranks(str(tmp_path / "w"), "distill_step",
                      dict(cfg0=cfg0, cfg1=cfg1, json=json_path, images=images,
                           workdir=os.path.join(tmp, "dp")))
    r0 = ranks[0]
    assert r0["warm"] == "output" and r0["teacher"]
    for m in r0["m0"] + r0["m1"]:
        assert np.isfinite(m["total_loss"])
    assert all("dist_feat_loss" in m and np.isfinite(m["dist_feat_loss"]) for m in r0["m1"])
    assert r0["sums"] == ranks[1]["sums"] and r0["m1"] == ranks[1]["m1"]

    cfg0, cfg1 = cfgs(os.path.join(tmp, "one"), tcfg.MeshConfig())
    tr0 = ILTrainer(cfg0, json_path, images, workdir=os.path.join(tmp, "one"), device="cpu")
    tr0.cur_epoch = tr0.end_epoch = 1
    tr0.warm_up(1)
    batch = next(iter(tr0.train_loader))
    m0 = [tr0.run_batch(batch), tr0.run_batch(batch)]
    tr0.save(1)
    tr0.ckpt.wait()
    tr1 = ILTrainer(cfg1, json_path, images, workdir=os.path.join(tmp, "one"), device="cpu")
    tr1.cur_epoch = tr1.end_epoch = 1
    batch = next(iter(tr1.train_loader))
    m1 = [tr1.run_batch(batch), tr1.run_batch(batch)]
    for got, want in zip(r0["m0"] + r0["m1"], m0 + m1):
        assert set(got) == set(want)
        for k in want:
            # the distillation terms are ~1e-8 here (the student starts as
            # its teacher): rounding, held absolutely
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert_params_close(r0["params"], tr1.model.state_dict())


# ------------------------------------------------------------ the battery

BATTERY = dict(distill=tcfg.DistillConfig(enabled=True), mas=tcfg.MASConfig(enabled=True),
               agem=tcfg.AGEMConfig(enabled=True, refresh_every=2),
               bic=tcfg.BiCConfig(enabled=True),
               replay=tcfg.ReplayConfig(sample_num=2, sample_method="random",
                                        sample_batch_size=2))


@pytest.fixture(scope="module")
def battery(toy, tmp_path_factory):
    """States 0 and 1 of scenario 3+2 with the battery, one epoch each: one
    process and two ranks."""
    tmp = tmp_path_factory.mktemp("mesh_battery")
    roots = {k: str(tmp / k) for k in ("one", "dp")}
    cfg = lambda k, mesh: mesh_cfg(os.path.join(roots[k], "ck"), ["3", "2"], mesh,
                                   end_state=1, end_epoch=1, **BATTERY)
    one = single(cfg("one", tcfg.MeshConfig()), toy, roots["one"])
    ranks = on_ranks(tmp / "w", cfg("dp", tcfg.MeshConfig(enabled=True)), toy, roots["dp"])
    yield dict(one=one, ranks=ranks, roots=roots, tmp=tmp)
    shutil.rmtree(tmp, ignore_errors=True)


def test_two_state_battery_matches_single_process(battery, toy, monkeypatch):
    """The battery on two ranks equals one process's; then ``cli.validate
    --mesh`` of its state-1 checkpoint (one test: a second test of the
    same run would repeat it on every test worker that runs one)."""
    one, ranks = battery["one"], battery["ranks"]
    assert_ranks_agree(ranks)
    r0 = ranks[0]
    assert r0["cur_state"] == 1 and r0["epochs"] == [(0, 1), (1, 1)]
    assert r0["exemplars"] == ranks[1]["exemplars"] == list(one.dataset_replay.image_ids)
    assert r0["bic"] == ranks[1]["bic"]
    for got, want in zip(r0["bic"], (one.bic.params.alphas.tolist(),
                                     one.bic.params.betas.tolist())):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert r0["bic"] != ([1.0], [0.0])                      # BiC trained
    assert r0["mas_keys"] == sorted(one.mas_importance)
    assert r0["replay_grad"].keys() == one.agem.replay_grad.keys()
    for k, g in one.agem.replay_grad.items():                # the last refresh's
        np.testing.assert_allclose(r0["replay_grad"][k].numpy(), g.numpy(), rtol=RTOL,
                                   atol=ATOL * max(float(g.abs().max()), 1.0), err_msg=k)
    assert_params_close(r0["params"], one.model.state_dict())
    np.testing.assert_allclose(r0["loss_hist"], list(one.loss_hist), rtol=1e-3)
    for f in ("3_2/state0/mas_importance.npz", "3_2/state1/examplar.json",
              "3_2/state1/epoch1/il_meta.json"):
        assert f in r0["files"], f
    _check_validate_mesh(battery, toy, monkeypatch)


def _validate_argv(root, toy, *extra):
    return ["--cpu", "--root_dir", root, "--test_json", os.path.join(toy, "test.json"),
            "--image_dir", os.path.join(toy, "images"), "--scenario", "3", "2",
            "--state", "1", "--epoch", "1", "--depth", "18", "--image_height", "128",
            "--image_width", "192", "--min_side", "100", "--max_side", "192",
            "--batch_size", "4", "--threshold", "0.001", "--record", "false", "--bic", "true",
            *extra]


def _check_validate_mesh(battery, toy, monkeypatch):
    """``cli.validate --mesh --bic true`` of the battery's state-1
    checkpoint on two ranks: the rows rank 0 wrote and the mAP every rank
    returns equal one process's at the detection bar."""
    root = battery["roots"]["dp"]
    src = os.path.join(root, "ck")
    for sub in ("one_v", "dp_v"):                       # validate reads <root>/checkpoint
        shutil.copytree(src, os.path.join(battery["tmp"], sub, "checkpoint"))
    ranks = run_ranks(str(battery["tmp"] / "wv"), "validate", dict(model=MODEL, argv=_validate_argv(
        str(battery["tmp"] / "dp_v"), toy, "--mesh", "true")))
    monkeypatch.setattr(common, "ModelConfig", functools.partial(tcfg.ModelConfig, **MODEL))
    want = validate.main(_validate_argv(str(battery["tmp"] / "one_v"), toy))
    assert ranks[0] == ranks[1]
    (ap0, per0), = ranks[0].values()
    np.testing.assert_allclose(ap0, want[1].mean_ap50, rtol=1e-4, atol=1e-6)
    rows = []
    for sub in ("dp_v", "one_v"):
        with open(os.path.join(battery["tmp"], sub, "val_result", "3_2", "state1",
                               "voc2007_results_epoch1_bic.json")) as f:
            rows.append(json.load(f))
    got, want_rows = rows
    assert len(got) == len(want_rows) > 0
    # each row paired with one of the same image and class at the bar: rows
    # of near-equal score may come in either order
    free = {}
    for g in got:
        free.setdefault((g["image_id"], g["category_id"]), []).append(g)
    for w in want_rows:
        cands = free.get((w["image_id"], w["category_id"]), [])
        match = next((i for i, g in enumerate(cands)
                      if abs(g["score"] - w["score"]) <= 1e-4 * abs(w["score"]) + 1e-6
                      and np.allclose(g["bbox"], w["bbox"], rtol=1e-4, atol=1e-3)), None)
        assert match is not None, w
        cands.pop(match)


# -------------------------------------------- two processes through the CLI

NARROW_CLI = f"""
import functools, sys
from cl_object_detection_tpu_torch import config
from cl_object_detection_tpu_torch.cli import common, train
common.ModelConfig = functools.partial(config.ModelConfig, **{MODEL!r})
train.main(sys.argv[1:])
"""

def _cli(toy, root, *extra):
    json_path, images = _paths(toy)
    return ["--cpu", "--root_dir", root, "--train_json", json_path, "--image_dir", images,
            "--test_json", os.path.join(toy, "test.json"), "--scenario", "5", "--depth", "18",
            "--image_height", "128", "--image_width", "192", "--min_side", "100",
            "--max_side", "192", "--batch_size", "4", "--end_epoch", "1", "--record", "false",
            "--print_il_info", "false", "--val", "true", *extra]


def test_two_process_cli_train_matches_one_process(toy, tmp_path):
    """``cli.train`` as two processes joined by the process flags: rank 0
    alone writes, both read the checkpoint (``--val true``), and the
    trained checkpoint and the validated rows equal one process's."""
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    # a file store of the test's own: a TCP port picked free could be taken
    # by another test before rank 0 binds it
    address = f"file://{tmp_path / 'store'}"
    mod = ["-c", NARROW_CLI]
    procs = [subprocess.Popen([sys.executable, *mod, *_cli(
        toy, str(tmp_path / "dp"), "--mesh", "true", "--coordinator_address", address,
        "--num_processes", "2", "--process_id", str(r))], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    one = subprocess.Popen([sys.executable, *mod, *_cli(toy, str(tmp_path / "one"))],
                           env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    outs = []
    try:
        for p in procs + [one]:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs + [one]:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs + [one], outs):
        assert p.returncode == 0, out[-3000:]
    assert "mesh: {'data': 2, 'model': 1} over 2 devices (rank 1" in outs[1]
    assert "gloo on the CPU" in outs[0]
    assert "epoch 1: mAP50=" in outs[0] and "epoch 1: mAP50=" not in outs[1]
    ck = lambda r: torch.load(os.path.join(str(tmp_path), r, "checkpoint", "5", "state0",
                                           "epoch1", "state.pt"), weights_only=True)
    dp, single_run = ck("dp"), ck("one")
    assert_params_close(dp["model"], single_run["model"])
    assert dp["step"] == single_run["step"]
    # at the default threshold 0.05 a model trained one epoch detects
    # nothing; the rows at 0.001 are held in test_validate_mesh_matches_one_process
    rows = [json.load(open(os.path.join(str(tmp_path), r, "val_result", "5", "state0",
                                        "voc2007_results_epoch1.json"))) for r in ("dp", "one")]
    assert rows[0] == rows[1]
