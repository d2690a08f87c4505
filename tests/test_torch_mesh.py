"""The port's mesh data axis (``parallel/mesh.py``) on the CPU: its
collectives on two gloo ranks, the backend rule and the device of a rank,
the loader's per-rank slices (JAX's tests/test_multihost.py mirrored),
rank 0's single writer in ``utils/checkpoint.py``, and the CLI flags.

The multi-rank cases run in fresh processes (``tests/torch_mesh_worker.py``)
that join a gloo group through a ``file://`` store in the test's own
directory, each joined with a timeout.
"""
import os
import sys

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch.config import DataConfig, MeshConfig
from cl_object_detection_tpu_torch.data.coco import CocoJson
from cl_object_detection_tpu_torch.data.dataset import ILDataset
from cl_object_detection_tpu_torch.data.loader import BatchLoader
from cl_object_detection_tpu_torch.parallel import mesh as pm
from cl_object_detection_tpu_torch.states import ILStates
from cl_object_detection_tpu_torch.utils import checkpoint as ckpt_mod
from cl_object_detection_tpu_torch.utils.toydata import DEFAULT_CLASSES, make_toy_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import run_ranks  # noqa: E402

torch.set_num_threads(1)


# ------------------------------------------------------------ collectives

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return run_ranks(str(tmp_path_factory.mktemp("mesh_coll")), "collectives", {})


def test_all_reduce_grads_is_the_mean_on_every_rank(collectives):
    """Rank r's gradient (r + 1) * g: the mean 1.5 g, the same bits on both
    ranks; metrics averaged, a count summed."""
    for r in collectives:
        np.testing.assert_array_equal(r["grads"]["a"], np.full((3, 2), 1.5, np.float32))
        np.testing.assert_array_equal(r["grads"]["b"], np.arange(4.0, dtype=np.float32) * 1.5)
        assert r["metrics"] == {"x": 0.5, "y": 1.0}
        assert r["count"] == 3.0


def test_broadcasts_and_gathers_give_rank0s(collectives):
    for r in collectives:
        assert r["obj"] == {"rank": 0} and r["gathered"] == [0, 1]
        np.testing.assert_array_equal(r["weight"], np.zeros((2, 3), np.float32))
        assert r["shape"] == {"data": 2, "model": 1} and r["backend"] == "gloo"
    assert [r["rank"] for r in collectives] == [0, 1]
    assert collectives[0]["sums"] == collectives[1]["sums"]


def test_check_replicas_raises_when_the_ranks_part(collectives):
    assert all(r["parted_raised"] for r in collectives)


# ------------------------------------------------- mesh, backend, devices

def test_create_mesh_without_a_group_is_one_rank():
    m = pm.create_mesh(MeshConfig(enabled=True), torch.device("cpu"))
    assert (m.rank, m.world, m.backend) == (0, 1, None) and not pm.active(m)
    assert m.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        pm.create_mesh(MeshConfig(enabled=True, num_data=2), torch.device("cpu"))


@pytest.mark.parametrize("cfg", [MeshConfig(zero1=True), MeshConfig(num_model=2)])
def test_zero1_and_model_axis_name_item_6b(cfg):
    """ZeRO-1 (item 6b-i) builds the mesh, where one rank splits nothing
    (JAX's ``zero1_extend_spec`` at ``ndata <= 1``). The model axis (item
    6b-ii, once refused here) takes JAX's check that ``num_data x
    num_model`` equals the devices; a rank of a 2 x 2 mesh knows its
    place (data index r // 2, model index r % 2) and splits only the head
    trunks' leaves (tests/test_torch_model_axis.py holds them to JAX)."""
    linear = torch.nn.Linear(4, 2)
    if cfg.zero1:
        m = pm.create_mesh(cfg, torch.device("cpu"))
        assert m.world == 1 and not m.zero1
        assert pm.shard_plans(m, linear.named_parameters()) == [
            {"weight": None, "bias": None}]
        return
    with pytest.raises(ValueError, match="mesh 0x2 != 1 devices"):
        pm.create_mesh(cfg, torch.device("cpu"))
    m = pm.DataMesh(rank=3, world=4, device=torch.device("cpu"), backend="gloo", num_model=2)
    assert m.shape == {"data": 2, "model": 2} and (m.data_index, m.model_index) == (1, 1)
    assert pm.proc_shard(m) == {"process_index": 1, "process_count": 2}
    trunk = torch.nn.Module()
    trunk.regression_head = torch.nn.Module()
    trunk.regression_head.conv1 = torch.nn.Conv2d(8, 8, 3)
    trunk.regression_head.output = torch.nn.Conv2d(8, 4, 3)
    plans = pm.shard_plans(m, trunk.named_parameters())
    assert plans[3] == {"regression_head.conv1.weight": ((0, slice(4, 8)),),
                        "regression_head.conv1.bias": ((0, slice(4, 8)),),
                        "regression_head.output.weight": None,
                        "regression_head.output.bias": None}
    assert plans[1] == plans[3] and plans[0] == plans[2] != plans[3]


def test_backend_rule(monkeypatch):
    """NCCL only when each of the host's ranks has a card of its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.backend_for(torch.device("cuda", 0), 2) == "nccl"
    assert pm.backend_for(torch.device("cuda", 0), 3) == "gloo"
    assert pm.backend_for(torch.device("cpu"), 1) == "gloo"


def test_host_placement_counts_the_ranks_of_each_host():
    hosts = ["a", "a", "b", "b", "a"]
    assert [pm.host_placement(r, hosts) for r in range(5)] == [
        (0, 3), (1, 3), (0, 2), (1, 2), (2, 3)]
    assert pm.host_placement(0, ["solo"]) == (0, 1)


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    called = []
    monkeypatch.setattr(pm.dist, "init_process_group", lambda *a, **k: called.append(a))
    monkeypatch.delenv("RANK", raising=False)
    assert pm.init_distributed(cpu=True) == torch.device("cpu")
    assert pm.init_distributed("127.0.0.1:1", 1, 0, cpu=True) == torch.device("cpu")
    assert not called


def _fake_group(monkeypatch, cards, hosts):
    """init_distributed's collaborators replaced: ``cards`` CUDA devices,
    a rendezvous that reports ``hosts`` (every rank's host name), and an
    ``init_process_group`` that records its calls."""
    calls = []
    store = object()
    monkeypatch.setattr(pm.dist, "init_process_group", lambda b, **k: calls.append((b, k)))
    monkeypatch.setattr(pm.dist, "PrefixStore", lambda prefix, st: (prefix, st))
    monkeypatch.setattr(pm, "_rendezvous", lambda method, rank, world: (
        calls.append(("rendezvous", method)) or (store, hosts)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.delenv("RANK", raising=False)
    return calls, store


def test_init_distributed_device_rules(monkeypatch):
    """Rank r on cuda:(local rank % cards); the process flags may share a
    card (gloo), torchrun's more ranks than cards raise; no CUDA raises
    without --cpu."""
    calls, store = _fake_group(monkeypatch, 1, ["h", "h"])
    dev = pm.init_distributed("127.0.0.1:5", 2, 1)
    assert dev == torch.device("cuda", 0) and calls[-1][0] == "gloo"
    assert calls[-2] == ("rendezvous", "tcp://127.0.0.1:5")
    assert calls[-1][1]["store"] == ("default_pg", store)
    assert calls[-1][1]["timeout"] == pm.DEFAULT_TIMEOUT
    assert (calls[-1][1]["rank"], calls[-1][1]["world_size"]) == (1, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.init_distributed("127.0.0.1:5", 2, 1) == torch.device("cuda", 1)
    assert calls[-1][0] == "nccl"
    _fake_group(monkeypatch, 1, ["h", "h", "h"])
    for k, v in dict(RANK="1", WORLD_SIZE="3", LOCAL_RANK="1", LOCAL_WORLD_SIZE="3").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no device of its own"):
        pm.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.init_distributed("127.0.0.1:5", 2, 0)
    with pytest.raises(ValueError, match="outside"):
        pm.init_distributed("127.0.0.1:5", 2, 2, cpu=True)


@pytest.mark.parametrize("torchrun", [False, True])
def test_two_hosts_of_two_cards_take_nccl(monkeypatch, torchrun):
    """Four ranks on two hosts of two cards each, started by the process
    flags or by torchrun: every rank has a card of its own (its place
    among its host's ranks), so the group is NCCL."""
    hosts = ["h0", "h0", "h1", "h1"]
    for rank in range(4):
        calls, _ = _fake_group(monkeypatch, 2, hosts)
        if torchrun:
            monkeypatch.setenv("RANK", str(rank))
            monkeypatch.setenv("WORLD_SIZE", "4")
            dev = pm.init_distributed()
        else:
            dev = pm.init_distributed("10.0.0.1:5", 4, rank)
        assert dev == torch.device("cuda", rank % 2), rank
        assert calls[-1][0] == "nccl", rank
        assert calls[-2] == ("rendezvous", "env://" if torchrun else "tcp://10.0.0.1:5")


def test_two_ranks_per_card_on_two_hosts_take_gloo(monkeypatch):
    """Two hosts of one card with two ranks each (the process flags):
    every rank shares its host's card, so the group is gloo."""
    for rank in range(4):
        calls, _ = _fake_group(monkeypatch, 1, ["h0", "h0", "h1", "h1"])
        assert pm.init_distributed("10.0.0.1:5", 4, rank) == torch.device("cuda", 0)
        assert calls[-1][0] == "gloo"


# --------------------------------------------- loader slices (multihost)

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_mesh"))
    json_path = make_toy_dataset(root, num_images=16, seed=11, image_size=(48, 64))
    coco = CocoJson(json_path)
    states = ILStates(list(DEFAULT_CLASSES), coco.classes_inverse, [5], shuffle_class=False)
    ds = ILDataset(coco, states, root + "/images", split="train", start_state=0)
    cfg = DataConfig(batch_size=4, height=128, width=192, max_boxes=10, min_side=100,
                     max_side=192, num_workers=0)
    return ds, cfg


def _all_batches(loader, epoch=0):
    loader.set_epoch(epoch)
    return list(iter(loader))


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_loader_process_slices_tile_global_batch(toy, nproc):
    ds, cfg = toy
    mk = lambda **kw: BatchLoader(ds, cfg, shuffle=True, augment=True, seed=7, prefetch=0,
                                  **kw)
    global_batches = _all_batches(mk())
    shards = [_all_batches(mk(process_index=p, process_count=nproc)) for p in range(nproc)]
    assert all(len(s) == len(global_batches) for s in shards)
    for b, gb in enumerate(global_batches):
        for field in ("images", "boxes", "labels", "num_boxes", "num_pseudo", "scales",
                      "image_ids"):
            got = np.concatenate([getattr(shards[p][b], field) for p in range(nproc)])
            np.testing.assert_array_equal(got, getattr(gb, field), err_msg=f"{b} {field}")
            assert getattr(shards[0][b], field).shape[0] == cfg.batch_size // nproc


def test_loader_slices_identical_across_epochs_and_augment(toy):
    ds, cfg = toy
    mk = lambda **kw: BatchLoader(ds, cfg, shuffle=True, augment=True, seed=3, prefetch=0,
                                  **kw)
    for epoch in (0, 1):
        gb = _all_batches(mk(), epoch)
        s0 = _all_batches(mk(process_index=0, process_count=2), epoch)
        s1 = _all_batches(mk(process_index=1, process_count=2), epoch)
        for b in range(len(gb)):
            np.testing.assert_array_equal(np.concatenate([s0[b].images, s1[b].images]),
                                          gb[b].images)


def test_loader_rejects_indivisible_batch(toy):
    ds, cfg = toy
    with pytest.raises(ValueError, match="not divisible"):
        BatchLoader(ds, cfg, batch_size=3, process_count=2)


# ----------------------------------------- checkpoints: rank 0 writes

def _fake_rank(monkeypatch, rank, log):
    monkeypatch.setattr(pm, "barrier", lambda mesh: log.append(mesh.rank))
    return pm.DataMesh(rank=rank, world=2, device=torch.device("cpu"), backend="gloo")


def _tiny():
    model = torch.nn.Linear(2, 2)
    return model, torch.optim.SGD(model.parameters(), lr=0.1)


def test_checkpoint_nonprimary_writes_nothing(tmp_path, monkeypatch):
    barriers = []
    mgr = ckpt_mod.CheckpointManager(str(tmp_path / "ck"), [5],
                                     mesh=_fake_rank(monkeypatch, 1, barriers))
    model, opt = _tiny()
    path = mgr.save(0, 1, model, opt, 3, il_meta={"x": 1}, async_save=True)
    side = mgr.save_sidecar(0, "examplar", [1, 2])
    arr = mgr.save_array_sidecar(0, "similarity", {"[0]": np.ones(2)})
    mgr.auto_delete(0, 1)
    mgr.wait()
    assert not os.path.exists(str(tmp_path / "ck"))         # not even a directory
    assert not any(map(os.path.exists, (path, side, arr)))
    assert mgr.epochs(0) == [] and mgr.load_sidecar(0, "examplar") is None
    assert barriers == [1, 1, 1, 1]                           # 3 saves + wait


def test_checkpoint_primary_writes_synchronously_and_barriers(tmp_path, monkeypatch):
    """On the mesh an async save is synchronous (no collective in a writer
    thread); rank 1 reads what rank 0 wrote."""
    barriers = []
    mgr0 = ckpt_mod.CheckpointManager(str(tmp_path), [5],
                                      mesh=_fake_rank(monkeypatch, 0, barriers))
    model, opt = _tiny()
    p = mgr0.save(0, 1, model, opt, 3, il_meta={"x": 1}, async_save=True)
    assert mgr0._pending is None and os.path.exists(os.path.join(p, "il_meta.json"))
    mgr0.save_array_sidecar(0, "similarity", {"[0]": np.ones(2)})
    assert barriers == [0, 0]
    mgr1 = ckpt_mod.CheckpointManager(str(tmp_path), [5], mesh=_fake_rank(monkeypatch, 1, []))
    tree, meta = mgr1.restore(0, 1)
    assert meta == {"x": 1} and int(tree["step"]) == 3
    assert torch.equal(tree["model"]["weight"], model.weight.detach())
    assert mgr1.epochs(0) == [1]
    np.testing.assert_array_equal(mgr1.load_array_sidecar(0, "similarity")["[0]"], np.ones(2))
