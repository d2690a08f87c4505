"""The port's spans and counters (``utils/profiling.py``) on the CPU: what a
micro-step and a served batch record with and without a profiler, how the
spans nest in the profiler's trace, the self time of a hand-made nest,
``--profile``'s ``spans.json`` and the loader's wait. One test runs on the
card (marked ``cuda``; on a machine with a card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py``).

The trainer is a state-1 R18 (FPN 32, 2 head layers, float32) of scenario
3+2 with distillation from the frozen state-0 teacher, entered at epoch 2
through the two states' checkpoints, with ``every_iter`` 2.
"""
import json
import os

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.cli.serve import make_run_predict
from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.train import loop
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils import checkpoint as ck
from cl_object_detection_tpu_torch.utils import profiling
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

TRAIN = ("cldet.train.step", "cldet.train.forward", "cldet.train.teacher",
         "cldet.train.backward", "cldet.train.apply")
MODEL = tcfg.ModelConfig(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")


def _trainer(root: str, device: str = "cpu") -> ILTrainer:
    json_path = make_toy_dataset(root, num_images=4, image_size=(48, 64), seed=3)
    cfg = tcfg.TrainConfig(
        model=MODEL,
        data=tcfg.DataConfig(batch_size=2, min_side=48, max_side=64, height=64, width=64,
                             max_boxes=8, num_workers=0, prefetch=0),
        schedule=tcfg.ScheduleConfig(lr=1e-5, every_iter=2),
        il=tcfg.ILConfig(scenario=("3", "2"), start_state=1,
                         distill=tcfg.DistillConfig(enabled=True)),
        checkpoint_dir=os.path.join(root, "ckpt"), start_epoch=2, record=False)
    mgr = ck.CheckpointManager(cfg.checkpoint_dir, cfg.il.scenario)
    for state, classes in ((0, 3), (1, 5)):
        model = create_retinanet(MODEL, classes, device="cpu",
                                 generator=torch.Generator().manual_seed(state))
        path = mgr.epoch_dir(state, 1)
        os.makedirs(path)
        torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0},
                   os.path.join(path, ck.STATE_FILE))
    return ILTrainer(cfg, json_path, os.path.join(root, "images"), workdir=root, device=device)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    return _trainer(str(tmp_path_factory.mktemp("spans_trainer")))


@pytest.fixture
def fresh():
    """Empty span list and counters before and after the test."""
    profiling.clear_spans()
    profiling.reset_counters()
    yield
    profiling.clear_spans()
    profiling.reset_counters()


def _calls(name: str) -> int:
    return profiling.counters().get(name, profiling.Count(0, 0)).calls


def test_micro_steps_without_a_profiler_record_nothing_and_count(trainer, fresh):
    batch = next(iter(trainer.train_loader))
    for _ in range(2):
        trainer.run_batch(batch, sync_metrics=False)
    assert profiling.spans() == []
    assert [_calls(n) for n in TRAIN] == [2, 2, 2, 2, 1]


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("cldet.")]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiled_micro_steps_nest_in_the_trace(trainer, fresh, tmp_path):
    """Under ``torch.profiler`` each micro-step is one ``cldet.train.step``
    range with ``forward`` (holding ``teacher``) and ``backward`` inside
    it, and ``apply`` inside every second one; ``spans()`` has the same
    nest, the children sharing their root's call."""
    batch = next(iter(trainer.train_loader))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            trainer.run_batch(batch, sync_metrics=False)
    got = _annotations(prof, tmp_path)
    by = {n: [g for g in got if g[0] == n] for n in TRAIN}
    assert [len(by[n]) for n in TRAIN] == [4, 4, 4, 4, 2]
    steps = sorted(by["cldet.train.step"], key=lambda g: g[1])
    for name in TRAIN[1:]:
        for g in by[name]:
            assert sum(_inside(g, s) for s in steps) == 1, name
    for g in by["cldet.train.teacher"]:
        assert any(_inside(g, f) for f in by["cldet.train.forward"])
    applied = [i for i, s in enumerate(steps) if any(_inside(a, s) for a in
                                                     by["cldet.train.apply"])]
    assert applied == [1, 3]

    spans = profiling.spans()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["cldet.train.step"] * 4
    assert [spans[i].call for i in roots] == [0, 1, 2, 3]
    parent_of = {"cldet.train.forward": "cldet.train.step",
                 "cldet.train.teacher": "cldet.train.forward",
                 "cldet.train.backward": "cldet.train.step",
                 "cldet.train.apply": "cldet.train.step"}
    for s in spans:
        if s.parent is not None:
            assert spans[s.parent].name == parent_of[s.name]
            assert s.call == spans[s.parent].call
        assert s.host_ms > 0 and s.stream_ms is None and s.self_stream_ms is None
    assert [_calls(n) for n in TRAIN] == [4, 4, 4, 4, 2]


def test_run_predict_records_the_serving_spans_in_order(fresh):
    model = create_retinanet(MODEL, 4, device="cpu", generator=torch.Generator().manual_seed(0))
    run_predict = make_run_predict(make_predict_fn(model, tcfg.PredictConfig()), "cpu")
    frames = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        out = run_predict(frames)
    spans = profiling.spans()
    assert [s.name for s in spans] == ["cldet.serve.batch", "cldet.serve.copy_in",
                                       "cldet.predict.forward", "cldet.predict.postprocess",
                                       "cldet.serve.copy_out"]
    assert [s.parent for s in spans] == [None, 0, 0, 0, 0]
    assert spans[1].nbytes == frames.nbytes
    assert spans[4].nbytes == sum(v.nbytes for v in out.values())
    assert profiling.counters()["cldet.serve.copy_in"] == (1, frames.nbytes)


class _Event:
    """A stand-in for a CUDA event: a time on the stream, in ms."""

    def __init__(self, at: float):
        self.at = at

    def elapsed_time(self, end) -> float:
        return end.at - self.at


def _record(name, parent, call, first, last):
    rec = profiling._Record(name, parent, call, 0)
    rec.t0, rec.t1 = 1_000_000, 1_000_000 + int(1e6 * (last - first))
    rec.events = (_Event(first), _Event(last))
    return rec


def test_self_time_is_duration_less_what_children_cover(fresh, monkeypatch):
    """root 0..10 ms; children 1..3 and 2.5..4 (overlapping: covered once)
    and 6..12 (clipped at the root's end); a grandchild 1.5..2 counts in
    its parent only."""
    records = [_record("root", None, 0, 0.0, 10.0),
               _record("a", 0, 0, 1.0, 3.0),
               _record("a.a", 1, 0, 1.5, 2.0),
               _record("b", 0, 0, 2.5, 4.0),
               _record("c", 0, 0, 6.0, 12.0)]
    monkeypatch.setattr(profiling, "_RECORDS", records)
    spans = profiling.spans()
    assert [s.stream_ms for s in spans] == pytest.approx([10.0, 2.0, 0.5, 1.5, 6.0])
    assert spans[0].self_stream_ms == pytest.approx(10.0 - 3.0 - 4.0)
    assert spans[1].self_stream_ms == pytest.approx(1.5)
    assert [s.self_stream_ms for s in spans[2:]] == pytest.approx([0.5, 1.5, 6.0])
    assert spans[0].host_ms == pytest.approx(10.0)


def test_profile_dir_writes_the_span_totals(fresh, tmp_path):
    """``start_trace_guarded`` clears the list, ``stop_trace_guarded``
    writes ``spans.json`` beside the trace: per name, calls and bytes and
    the host ms of the spans recorded in the window."""
    with profiling.span("before"):
        pass
    profiling.start_trace_guarded(str(tmp_path / "prof"))
    try:
        for i in range(3):
            with profiling.span("outer", nbytes=10):
                with profiling.span("inner", nbytes=i):
                    torch.ones(8).sum()
    finally:
        assert profiling.stop_trace_guarded()
    with open(tmp_path / "prof" / "spans.json") as f:
        totals = json.load(f)
    assert set(totals) == {"outer", "inner"}
    assert (totals["outer"]["calls"], totals["outer"]["bytes"]) == (3, 30)
    assert (totals["inner"]["calls"], totals["inner"]["bytes"]) == (3, 3)
    assert totals["outer"]["host_ms"] >= totals["inner"]["host_ms"] > 0
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    assert profiling.counters()["before"] == (1, 0)


def test_each_loader_wait_is_a_span(fresh):
    waits = []
    assert list(loop._timed([1, 2, 3], waits)) == [1, 2, 3]
    assert len(waits) == 4 and _calls("cldet.train.loader_wait") == 4


@pytest.mark.cuda
def test_root_stream_time_is_its_children_plus_its_self_on_the_card(tmp_path, fresh):
    """Two micro-steps of the trainer on the card under the profiler: each
    root's stream ms equals its children's stream ms plus its own self
    ms, within 1% (the children tile the root's stretch of the stream)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer = _trainer(str(tmp_path), device="cuda")
    batch = next(iter(trainer.train_loader))
    for _ in range(2):                  # the first shapes' plans and allocations
        trainer.run_batch(batch, sync_metrics=False)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            trainer.run_batch(batch, sync_metrics=False)
    spans = profiling.spans()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert len(roots) == 2
    for i in roots:
        kids = [s.stream_ms for s in spans if s.parent == i]
        assert len(kids) >= 2 and all(k > 0 for k in kids)
        root = spans[i]
        assert root.self_stream_ms >= 0
        assert sum(kids) + root.self_stream_ms == pytest.approx(root.stream_ms, rel=0.01)
