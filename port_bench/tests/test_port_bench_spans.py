"""The readers of the program's spans (``metrics/_spans.py`` and the eleven
metrics on it) on synthetic span lists and traces: which spans are this
run's, the per-call arithmetic, the idle gaps put down to the innermost
``cldet.`` span, and None from a program without spans."""
import pytest

from cl_object_detection_tpu_torch.utils import profiling
from port_bench import registry, trace

TRAIN_READERS = ("teacher_ms.train", "student_ms.train", "backward_ms.train", "apply_ms.train",
                 "apply_host_ms.train", "backward_idle_ms.train", "apply_idle_ms.train")
PREDICT_READERS = ("copy_in_ms.predict", "copy_out_ms.predict", "forward_span_ms.predict",
                   "postprocess_span_ms.predict")


def _read(metric, rec):
    return registry.reader(metric).read(rec)


class _Spans:
    """A span list built call by call, as ``profiling.spans()`` gives it."""

    def __init__(self):
        self.spans, self.calls = [], 0

    def root(self, name, host, stream, self_ms):
        self.spans.append(profiling.Span(name, None, self.calls, 0, host, stream, self_ms))
        self.calls += 1
        return len(self.spans) - 1

    def child(self, parent, name, host, stream, self_ms=None, nbytes=0):
        call = self.spans[parent].call
        self.spans.append(profiling.Span(name, parent, call, nbytes, host, stream,
                                         stream if self_ms is None else self_ms))
        return len(self.spans) - 1


def _micro_step(sp, scale, apply):
    step = sp.root("cldet.train.step", 90.0 * scale, 100.0 * scale, 5.0 * scale)
    fwd = sp.child(step, "cldet.train.forward", 50.0, 60.0 * scale, 35.0 * scale)
    sp.child(fwd, "cldet.train.teacher", 20.0, 25.0 * scale)
    sp.child(step, "cldet.train.backward", 20.0, 30.0 * scale)
    if apply:
        sp.child(step, "cldet.train.apply", 12.0 * scale, 10.0 * scale)


def _train_spans():
    """A leftover root, then the device pass (2 micro-steps, one apply), a
    loader wait between them, then the host pass at 3x the times."""
    sp = _Spans()
    sp.root("cldet.train.step", 1.0, 1.0, 1.0)
    _micro_step(sp, 1.0, False)
    sp.root("cldet.train.loader_wait", 4.0, 4.0, 4.0)
    _micro_step(sp, 1.0, True)
    _micro_step(sp, 3.0, False)
    _micro_step(sp, 3.0, True)
    return sp.spans


@pytest.fixture
def spans_are(monkeypatch):
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: spans)
    return put


def test_train_readers_take_the_device_pass_per_micro_step(spans_are):
    spans_are(_train_spans())
    rec = {"kind": "train", "trace": trace.Trace(0.0, 1.0, iterations=2)}
    assert _read("teacher_ms.train", rec) == pytest.approx(25.0)
    assert _read("student_ms.train", rec) == pytest.approx(35.0)
    assert _read("backward_ms.train", rec) == pytest.approx(30.0)
    assert _read("apply_ms.train", rec) == pytest.approx(5.0)        # one apply in 2 steps
    assert _read("apply_host_ms.train", rec) == pytest.approx(12.0)  # per apply
    assert _read("copy_in_ms.predict", dict(rec, kind="predict")) is None


def test_predict_readers_take_the_device_pass_per_batch(spans_are):
    sp = _Spans()
    for scale in (1.0, 1.0, 2.0, 2.0):
        b = sp.root("cldet.serve.batch", 90.0, 80.0 * scale, 0.5)
        sp.child(b, "cldet.serve.copy_in", 10.0, 11.0 * scale, nbytes=64)
        sp.child(b, "cldet.predict.forward", 5.0, 68.0 * scale)
        sp.child(b, "cldet.predict.postprocess", 2.0, 1.25 * scale)
        sp.child(b, "cldet.serve.copy_out", 1.0, 0.25 * scale)
    spans_are(sp.spans)
    rec = {"kind": "predict", "trace": trace.Trace(0.0, 1.0, iterations=2)}
    got = [_read(m, rec) for m in PREDICT_READERS]
    assert got == pytest.approx([11.0, 0.25, 68.0, 1.25])
    assert _read("teacher_ms.train", dict(rec, kind="train")) is None
    # fewer roots than two passes: not this run's
    spans_are(sp.spans[:10])
    assert _read("copy_in_ms.predict", rec) is None


def _host_trace():
    # step 0..1000 us holds backward 300..600 (an aten op inside it) and
    # apply 700..900; the card is busy 0..300, 350..650, 700..720, 800..1000
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "cldet.train.step", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "cldet.train.backward", "ts": 300,
         "dur": 300},
        {"ph": "X", "cat": "cpu_op", "name": "aten::convolution_backward", "ts": 290,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "cldet.train.apply", "ts": 700,
         "dur": 200},
    ] + [{"ph": "X", "cat": "kernel", "name": "k", "ts": s, "dur": e - s}
         for s, e in ((0, 300), (350, 650), (700, 720), (800, 1000))]
    return trace.parse(events, iterations=2)


def test_idle_gaps_go_to_the_innermost_open_span():
    """Gaps 300..350 (backward), 650..700 (the step alone) and 720..800
    (apply), over 2 micro-steps."""
    rec = {"kind": "train", "host_trace": _host_trace()}
    assert _read("backward_idle_ms.train", rec) == pytest.approx(0.050 / 2)
    assert _read("apply_idle_ms.train", rec) == pytest.approx(0.080 / 2)


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent's program has no ``spans`` and its trace no ``cldet.``
    range: every reader returns None and raises nothing."""
    monkeypatch.delattr(profiling, "spans")
    tr = trace.Trace(0.0, 1000.0, iterations=2)
    tr.host.append(("aten::add", 0.0, 1000.0))
    for metric in TRAIN_READERS:
        assert _read(metric, {"kind": "train", "trace": tr, "host_trace": tr}) is None, metric
    for metric in PREDICT_READERS:
        assert _read(metric, {"kind": "predict", "trace": tr, "host_trace": tr}) is None
    assert _read("teacher_ms.train", {"kind": "train"}) is None


def test_the_span_metrics_are_entries_of_the_benchmark():
    per_layer = {m["name"]: m for m in registry.benchmark()["per_layer"]}
    for metric in TRAIN_READERS + PREDICT_READERS:
        m = per_layer[metric]
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["source"] == ("host_clock" if metric == "apply_host_ms.train"
                               else "device_trace")
        kind = metric.rsplit(".", 1)[1]
        assert m["moves"] == f"{kind}_images_per_s"
