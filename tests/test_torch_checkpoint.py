"""The port's ``utils/checkpoint.CheckpointManager`` (its own torch format,
the JAX package's layout and rules), the cases of the JAX package's
tests/test_checkpoint.py: round trip, retention, async save, sidecars,
the optimizer's state, ``nearest_epoch``; plus the async save's copy of
the tensors before its thread starts. Tensors must come back equal."""
import json
import os

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch.config import ModelConfig, ScheduleConfig
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.train.optim import make_optimizer
from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager, scenario_tag


@pytest.fixture()
def state():
    """An R18 model (FPN 32) and its optimizer after one Adam step."""
    model = create_retinanet(ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                                         compute_dtype="float32"), 3, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(ScheduleConfig(every_iter=1, classifier_lr_scale=10.0), model)
    g = torch.Generator().manual_seed(1)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    model.zero_grad(set_to_none=True)
    return model, opt


def _assert_model_equal(model, tree):
    sd = model.state_dict()
    assert set(sd) == set(tree)
    for k, v in sd.items():
        assert torch.equal(v, tree[k]), k


def test_roundtrip(tmp_path, state):
    model, opt = state
    mgr = CheckpointManager(str(tmp_path), ("10", "10"))
    path = mgr.save(0, 3, model, opt, step=7, il_meta={"state": 0, "epoch": 3, "num_classes": 3})
    assert path == os.path.join(str(tmp_path), "10_10", "state0", "epoch3")
    tree, meta = mgr.restore(0, 3)
    assert meta["epoch"] == 3 and tree["step"] == 7
    _assert_model_equal(model, tree["model"])
    assert scenario_tag(["15", "1"]) == "15_1"


def test_latest_and_retention(tmp_path, state):
    model, opt = state
    mgr = CheckpointManager(str(tmp_path), ("20",), keep_every=5)
    for e in (1, 2, 3, 4, 5, 6, 7):
        mgr.save(0, e, model, opt, step=e)
    assert mgr.latest_epoch(0) == 7
    mgr.auto_delete(0, 7)
    assert mgr.epochs(0) == [5, 7]     # multiples of 5 and the current epoch
    tree, _ = mgr.restore(0, -1)
    assert tree["step"] == 7
    with pytest.raises(FileNotFoundError):
        mgr.restore(1, -1)


def test_async_roundtrip(tmp_path, state):
    """Background write + atomic rename; readers wait(). The tensors are
    copied before the thread starts: changing the model after save()
    returns does not change what is written."""
    model, opt = state
    want = {k: v.clone() for k, v in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path), ("10", "10"))
    mgr.save(0, 1, model, opt, step=1, il_meta={"epoch": 1}, async_save=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    mgr.save(0, 2, model, opt, step=2, il_meta={"epoch": 2}, async_save=True)  # joins #1
    assert mgr.epochs(0) == [1, 2]
    tree, meta = mgr.restore(0, 1)
    assert meta["epoch"] == 1
    for k, v in want.items():
        assert torch.equal(tree["model"][k], v), k
    tree2, _ = mgr.restore(0, -1)
    _assert_model_equal(model, tree2["model"])
    assert [n for n in os.listdir(mgr.state_dir(0)) if n.startswith(".tmp")] == []


def test_async_save_error_surfaces_at_wait(tmp_path, state, monkeypatch):
    model, opt = state
    mgr = CheckpointManager(str(tmp_path), ("20",))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    mgr.save(0, 1, model, opt, step=1, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert [n for n in os.listdir(mgr.state_dir(0)) if n.startswith(".tmp")] == []
    assert mgr.epochs(0) == []


def test_sidecars(tmp_path):
    mgr = CheckpointManager(str(tmp_path), ("15", "1"))
    mgr.save_sidecar(1, "examplar", [3, 1, 4, 1, 5])
    assert mgr.load_sidecar(1, "examplar") == [3, 1, 4, 1, 5]
    assert mgr.load_sidecar(1, "nothing") is None
    arrays = {"a": np.arange(6).reshape(2, 3), "b.c": torch.ones(4)}
    mgr.save_array_sidecar(0, "mas_importance", arrays)
    back = mgr.load_array_sidecar(0, "mas_importance")
    np.testing.assert_array_equal(back["a"], arrays["a"])
    np.testing.assert_array_equal(back["b.c"], np.ones(4, np.float32))
    assert mgr.load_array_sidecar(0, "nothing") is None
    with open(os.path.join(mgr.state_dir(1), "examplar.json")) as f:
        assert json.load(f) == [3, 1, 4, 1, 5]


def test_optimizer_state_resume(tmp_path, state):
    """The Adam state (moments, counts, LR and betas of both groups)
    restores into a fresh optimizer of the same model."""
    model, opt = state
    opt.param_groups[1]["betas"] = (0.5, 0.999)
    mgr = CheckpointManager(str(tmp_path), ("20",))
    mgr.save(0, 1, model, opt, step=5)
    tree, _ = mgr.restore(0, 1)
    fresh = make_optimizer(ScheduleConfig(every_iter=1), model)
    fresh.load_state_dict(tree["optimizer"])
    assert fresh.state_dict()["param_groups"] == opt.state_dict()["param_groups"]
    assert [g["count"] for g in fresh.param_groups] == [1, 1]
    assert [g["lr"] for g in fresh.param_groups] == pytest.approx([1e-5, 1e-4])
    for p in model.parameters():
        for m in ("mu", "nu"):
            assert torch.equal(fresh.state[p][m], opt.state[p][m])


def test_nearest_epoch(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), ["5"], keep_every=5)
    for e in (2, 5, 9):
        os.makedirs(ckpt.epoch_dir(0, e), exist_ok=True)
    assert ckpt.nearest_epoch(0, 9) == 9
    assert ckpt.nearest_epoch(0, 8) == 5
    assert ckpt.nearest_epoch(0, 4) == 2
    assert ckpt.nearest_epoch(0, 1) is None
