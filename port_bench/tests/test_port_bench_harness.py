"""The harness's own machinery: discovery by name, the metric arithmetic
on synthetic records and traces, and what its modules import."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from port_bench import registry, trace
from port_bench.run import FORBIDDEN

BENCH = registry.benchmark()
ROOT = str(registry.ROOT)


def test_every_cell_finds_its_files_by_name():
    for w in BENCH["workloads"]:
        cell = registry.Cell(w["name"], bench=BENCH)
        kind = registry.kind(cell.traffic["kind"])
        assert callable(kind.run) and callable(kind.variants)
        assert set(kind.variants(cell.traffic)) >= {"control", "half_batch"}
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_the_data_axis_cell_is_ready_as_data():
    """The 4-card cell waits outside BENCHMARK.json (PERF.md, Open
    questions); its kind, traffic, limits and reader are all here."""
    from conftest import DATA_AXIS, bench_with_data_axis

    cell = registry.Cell(DATA_AXIS["name"], bench=bench_with_data_axis())
    assert cell.chips == 4 and cell.traffic["ranks"] == 4
    assert "no_exchange" in registry.kind(cell.traffic["kind"]).variants(cell.traffic)
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    tr = trace.Trace(0.0, 1000.0, iterations=1)
    read = registry.reader("nccl_share.train").read
    assert read({"kind": "train", "trace": tr}) is None
    tr.device.append(("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 100.0, 50.0))
    assert read({"kind": "train", "trace": tr}) == pytest.approx(5.0)


def test_every_metric_has_a_reader_and_every_config_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]).read), m["name"]
    for c in BENCH["configs"]:
        cfg = registry.load_json(registry.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(BENCH["paths"][0] + "/")


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_discovery_finds_a_new_cell_from_files_alone(tmp_path):
    """A later cell is a traffic file, a limits file and entries in
    BENCHMARK.json: no harness file changes."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(bench["workloads"][0], name="new-cell"))
    limits = registry.HERE / "workloads" / "new-cell.json"
    limits.write_text(json.dumps({"limits": {"miss_share": 0.5}}))
    try:
        cell = registry.Cell("new-cell", bench=bench)
        assert cell.limits == {"miss_share": 0.5}
        assert cell.traffic == registry.Cell(bench["workloads"][0]["name"], bench=bench).traffic
        assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    finally:
        limits.unlink()


def _read(metric, rec):
    return registry.reader(metric).read(rec)


def test_rates_are_over_the_whole_window():
    rec = {"kind": "predict", "items": 3200, "window_s": 8.0, "latencies_s": [0.1] * 100}
    assert _read("predict_images_per_s", rec) == 400.0
    assert _read("train_images_per_s", rec) is None
    assert _read("train_images_per_s", dict(rec, kind="train")) == 400.0


def test_p95_is_over_all_batches():
    lat = list(np.linspace(0.060, 0.079, 200)) + [0.5] * 5
    rec = {"kind": "predict", "latencies_s": lat}
    assert _read("predict_p95_ms", rec) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert _read("predict_p95_ms", {"kind": "predict", "latencies_s": [0.07] * 95 + [1.0] * 5}) \
        == pytest.approx(70.0 + 0.05 * 930.0, rel=1e-6)


def test_event_split_of_a_batch():
    rec = {"kind": "predict", "latencies_s": [0.080, 0.090],
           "events_ms": {"forward": [60.0, 62.0], "postprocess": [2.0, 2.0]}}
    assert _read("forward_ms.predict", rec) == 61.0
    assert _read("postprocess_ms.predict", rec) == 2.0
    assert _read("copy_ms.predict", rec) == pytest.approx(22.0)
    assert _read("forward_ms.predict", {"kind": "predict"}) is None


def _synthetic_trace():
    # window 0..1000 us: kernels 100..300 and 250..400 overlap, 600..700;
    # host ops around the gaps
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "stem_fused_kernel", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "void int8_matmul_kernel<1>", "ts": 250, "dur": 150},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 600, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 390, "dur": 300},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 450, "dur": 50},
    ]
    return trace.parse(events, iterations=2)


def test_busy_and_idle_share_from_a_timeline():
    tr = _synthetic_trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(400e-6)          # 100..400 and 600..700
    rec = {"kind": "predict", "trace": tr}
    assert _read("idle_share.predict", rec) == pytest.approx(60.0)
    assert _read("idle_share.train", rec) is None
    assert tr.kernel_s("int8_matmul_kernel") == (pytest.approx(150e-6), 1)


def test_device_pass_window_from_the_host_clock():
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 5000, "dur": 300},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 5500, "dur": 200}]
    tr = trace.parse(events, iterations=1, window_s=1e-3)
    assert (tr.start_us, tr.end_us) == (5000.0, 6000.0)
    assert tr.busy_s == pytest.approx(500e-6)
    with pytest.raises(RuntimeError):
        trace.parse(events, iterations=1)


def test_breakdown_of_device_ops_and_idle_gaps():
    tr = _synthetic_trace()
    assert tr.top_ops(2) == [["stem_fused_kernel", pytest.approx(200e-6)],
                             ["void int8_matmul_kernel<1>", pytest.approx(150e-6)]]
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # 0..100 under copy_, 400..600 under item (innermost at 400), 700..1000 none
    assert gaps == {"aten::copy_": pytest.approx(100e-6), "aten::item": pytest.approx(200e-6),
                    "(no host operator)": pytest.approx(300e-6)}


def test_rooflines_read_nothing_without_their_kernel():
    tr = trace.Trace(0.0, 1000.0, iterations=1)
    work = {"config": {"num_classes": 20, "depth": 50, "fpn_channels": 256, "num_anchors": 9,
                       "head_layers": 4}, "frame": (608, 832), "batch": 32, "int8": True}
    for name in ("stem_roofline.predict", "int8_roofline.predict"):
        assert _read(name, {"kind": "predict", "trace": tr, "work": work}) is None
    tr.device.append(("stem_fused_kernel", 0.0, 154.8025))
    got = _read("stem_roofline.predict", {"kind": "predict", "trace": tr, "work": work})
    assert got == pytest.approx(50.0, rel=1e-4)


def test_each_loss_term_is_compared_step_by_step():
    """A term of the wrong images reads its own gap while the total hides
    it; a term the program leaves out, or one not finite, reads inf."""
    import torch

    from port_bench import compare

    leaf = {"w": torch.ones(3)}
    ref = [{"fg": 0.5, "box": 0.20}, {"fg": 0.4, "box": 0.25}]
    prog = [{"fg": 0.5, "box": 0.26}, {"fg": 0.4, "box": 0.25}]
    got, _ = compare.train_steps([3.0, 3.0], [3.0, 3.0], leaf, leaf, leaf, leaf, prog, ref)
    assert got["loss_gap"] == 0.0 and got["fg_loss_gap"] == 0.0
    assert got["box_loss_gap"] == pytest.approx(0.3)
    got, _ = compare.train_steps([3.0, 3.0], [3.0, 3.0], leaf, leaf, leaf, leaf,
                                 [{"fg": 0.5}, {"fg": float("nan")}], ref)
    assert got["fg_loss_gap"] == float("inf") and got["box_loss_gap"] == float("inf")
    got, _ = compare.train_steps([3.0], [3.0], leaf, leaf, leaf, leaf, [], [])
    assert set(got) == {"loss_gap", "grad_gap", "change_gap"}


PROBE = r"""
import importlib, json, pkgutil, sys
import port_bench
names = []
for m in pkgutil.walk_packages(port_bench.__path__, "port_bench."):
    if ".tests" in m.name:
        continue
    importlib.import_module(m.name)
    names.append(m.name)
from port_bench import registry
bench = registry.benchmark()
for w in bench["workloads"]:
    cell = registry.Cell(w["name"], bench=bench)
    registry.kind(cell.traffic["kind"])
for m in bench["end_to_end"] + bench["per_layer"]:
    registry.reader(m["name"])
forbidden = set(sys.argv[1].split(","))
print(json.dumps({"modules": names,
                  "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in forbidden),
                  "program": sorted(m for m in sys.modules
                                    if m.split(".")[0] == "cl_object_detection_tpu_torch")}))
"""


def test_no_module_of_the_harness_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE, ",".join(FORBIDDEN)], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "port_bench.run" in got["modules"] and "port_bench.reference.train" in got["modules"]
    assert got["forbidden"] == []


def test_the_reference_imports_nothing_of_the_program():
    probe = ("import json, sys; import port_bench.reference.retinanet, "
             "port_bench.reference.detect, port_bench.reference.train; "
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('cl_object_detection_tpu_torch', 'cl_object_detection_tpu', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names():
    assert "cl_object_detection_tpu" in FORBIDDEN
    top = "cl_object_detection_tpu_torch.ops.quant".split(".")[0]
    assert top not in FORBIDDEN


def test_no_card_means_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "2147483659", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
