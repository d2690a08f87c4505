"""The port's tools (``cl_object_detection_tpu_torch/tools``) on the CPU:
``make_toy_dataset`` writes the JAX tool's COCO JSON (but the file
names' extension) and ``coco_tool`` prints what the JAX tool prints on
it; every measuring tool runs in this process with ``--cpu`` at the
smallest size (R18, 64x64 frames, a narrow FPN in float32) and prints
records of the stated keys that say ``"device": "cpu"``; without
``--cpu`` and without CUDA each raises."""
import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from cl_object_detection_tpu.utils import toydata as jtoy
from cl_object_detection_tpu_torch.data.image_io import encode_png
from cl_object_detection_tpu_torch.models.bridge import save_npz
from cl_object_detection_tpu_torch.tools import (
    bench_backbone,
    bench_bwd_breakdown,
    bench_fwd_floor,
    bench_int8_matmul,
    bench_loader,
    bench_nms,
    bench_serve,
    bench_split,
    bench_sweep,
    bench_train,
    coco_tool,
    common,
    make_toy_dataset,
    mem_report,
)
from cl_object_detection_tpu_torch.utils import benchlib

from test_torch_benchlib import seeded_variables
from test_torch_model import CFG, H, W

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = os.path.join(REPO, "tools")


def _jax_tool(name, argv):
    """Run the JAX package's ``tools/<name>.py`` as a script; its stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(JAX_TOOLS, f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _port_tool(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The JAX tool's and the port tool's sets from the same flags."""
    monkeypatch.setattr(jtoy, "_save_jpeg", lambda path, img: None)
    flags = ["--train", "7", "--test", "3", "--seed", "5", "--height", "40", "--width", "56",
             "--classes", "cat", "dog", "bird", "--style", "separable"]
    jout = _jax_tool("make_toy_dataset", ["--out", str(tmp_path / "j")] + flags)
    tout = _port_tool(make_toy_dataset.main, ["--out", str(tmp_path / "t")] + flags)
    return tmp_path, jout, tout


def test_make_toy_dataset_writes_the_jax_tools_json(toy):
    root, jout, tout = toy
    assert tout == jout.replace(str(root / "j"), str(root / "t"))
    for split in ("train", "test"):
        want = (root / "j" / f"{split}.json").read_text().replace(".jpg", ".png")
        assert (root / "t" / f"{split}.json").read_text() == want
    names = json.loads((root / "t" / "train.json").read_text())["images"]
    assert len(names) == 7
    assert all((root / "t" / "images" / im["file_name"]).exists() for im in names)


@pytest.mark.parametrize("cmd", [["stats"], ["classes"], ["imgs-by-cat", "--cats", "dog", "cat"],
                                 ["cats-by-img", "--imgs", "1", "2", "5"]])
def test_coco_tool_prints_what_the_jax_tool_prints(toy, cmd):
    root, _, _ = toy
    path = str(root / "t" / "train.json")
    argv = [cmd[0], path] + cmd[1:]
    want = _jax_tool("coco_tool", argv)
    assert want.strip()
    assert _port_tool(coco_tool.main, argv) == want


@pytest.fixture
def small_model(monkeypatch):
    """The tools' model as the narrow float32 R18 of the CPU tests."""
    real = common.build_model

    def build(depth, device, dtype="bfloat16", seed=0, **cfg):
        return real(depth, device, "float32", seed, fpn_channels=32, head_layers=2, **cfg)

    monkeypatch.setattr(common, "build_model", build)


def _records(main, argv):
    recs = [json.loads(line) for line in _port_tool(main, argv).splitlines()
            if line.startswith("{")]
    assert recs
    for r in recs:
        assert r["device"] == "cpu" and "card" not in r
        assert benchlib.finite_positive(r, r.get("differences", ())) == [], r
    return recs


SMALL = ["--cpu", "--depth", "18", "--height", "64", "--width", "64"]

TOOLS = {
    "bench_train": (bench_train.main, SMALL + ["--batch", "1", "--iters", "1", "--stem",
                                               "fused", "--split"],
                    {"forward_ms", "loss_ms", "backward_ms", "optimizer_ms", "full_step_ms",
                     "images_per_sec", "step_flops", "mfu_vs_h100_bf16_peak", "metric",
                     "launches"}),
    "bench_split": (bench_split.main, SMALL + ["--batch", "1", "--iters", "1", "--nms_impl",
                                               "pallas_fp", "fwd", "det", "full", "bb",
                                               "feats"],
                    {"mode", "batch", "frame", "topk", "ms_per_batch", "img_per_s",
                     "launches"}),
    "bench_sweep": (bench_sweep.main, SMALL + ["--iters", "1", "--stem", "fused", "--mfu", "1"],
                    {"batch", "stem", "depth", "img_per_s", "mfu", "launches"}),
    "bench_backbone": (bench_backbone.main, SMALL + ["--batch", "1", "--iters", "1"]
                       + list(bench_backbone.MODES),
                       {"mode", "batch", "ms_per_batch", "img_per_s", "launches"}),
    "bench_fwd_floor": (bench_fwd_floor.main, SMALL + ["--batch", "1", "--iters", "1"],
                        {"stage", "ms"}),
    "bench_bwd_breakdown": (bench_bwd_breakdown.main, SMALL + ["--batch", "1", "--iters", "1"],
                            {"stage", "fwd+bwd_ms"}),
    "bench_nms": (bench_nms.main, ["--cpu", "--k", "64", "--batch", "2", "--iters", "2"],
                  {"metric", "kind", "k", "batch", "value", "unit", "timer"}),
    "bench_int8_matmul": (bench_int8_matmul.main, ["--cpu", "--m", "64", "--k", "144", "--n",
                                                   "16", "--conv_hw", "4", "4", "--iters", "2"],
                          set()),
    "bench_loader": (bench_loader.main, ["--cpu", "--images", "4", "--batch", "2", "--workers",
                                         "0", "2", "--height", "48", "--width", "64",
                                         "--shape_buckets", "64x64", "--epochs", "2",
                                         "--fused"],
                     {"metric", "value", "unit", "workers", "image_format"}),
    "mem_report": (mem_report.main, ["--cpu", "--depth", "18", "50", "--batch", "2"],
                   {"depth", "batch", "remat", "frame", "param_gib", "grad_gib",
                    "adam_moments_gib", "measured"}),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu(tool, small_model):
    main, argv, keys = TOOLS[tool]
    recs = _records(main, argv)
    for r in recs:
        assert keys <= set(r), (tool, r)
    if tool == "bench_split":
        assert [r["mode"] for r in recs] == ["fwd", "det", "full", "bb", "feats"]
    elif tool == "bench_backbone":
        assert [r["mode"] for r in recs] == list(bench_backbone.MODES)
    elif tool == "bench_fwd_floor":
        assert [r["stage"] for r in recs] == ["s1", "s2", "s3", "s4", "stem(fused)"]
        assert all(r["bound"] in ("compute", "bandwidth") for r in recs[:4])
    elif tool == "bench_bwd_breakdown":
        assert [r["stage"] for r in recs] == ["backbone", "fpn", "cls_head", "reg_head", "loss",
                                             "full_grad"]
        assert all({"bwd/fwd", "fwd_ms"} <= set(r) for r in recs[:5])
    elif tool == "bench_nms":
        assert [(r["kind"], r["batch"]) for r in recs] == [
            (k, b) for b in (1, 2) for k in bench_nms.KINDS]
        assert len({r["kept"] for r in recs if r["batch"] == 1}) == 1   # one keep mask
    elif tool == "bench_int8_matmul":
        assert {"best_int8_kernel_vs_bf16_matmul", "conv_speedup_int8_vs_bf16"} <= set(recs[-1])
        assert len(recs) == 6
    elif tool == "bench_loader":
        assert [r["workers"] for r in recs] == [0, 2]
    elif tool == "mem_report":
        assert [r["depth"] for r in recs] == [18, 50]
        assert recs[0]["adam_moments_gib"] == 2 * recs[0]["grad_gib"]


def test_bench_serve_drives_one_server_on_the_cpu(tmp_path):
    """One ``cli.serve --cpu`` child (the bridged npz route), concurrency 1
    and 2 over 4 requests each, the JAX tool's record keys."""
    _, v = seeded_variables(2)
    save_npz(str(tmp_path / "w.npz"), v)
    with open(tmp_path / "params.json", "w") as f:
        json.dump({"model": {k: x for k, x in CFG.items() if k != "compute_dtype"},
                   "data": {"height": H, "width": W, "fused_stem": True}}, f)
    img = (np.random.RandomState(4).rand(50, 70, 3) * 255).astype(np.uint8)
    (tmp_path / "img.png").write_bytes(encode_png(img))
    recs = _records(bench_serve.main, [
        "--cpu", "--image", str(tmp_path / "img.png"), "--weights", str(tmp_path / "w.npz"),
        "--params_json", str(tmp_path / "params.json"), "--max_batch", "2",
        "--concurrency", "1", "2", "--requests", "4", "--warmup", "1",
        "--startup_timeout", "120"])
    assert [r["concurrency"] for r in recs] == [1, 2]
    for r in recs:
        assert {"metric", "concurrency", "requests", "errors", "p50_ms", "p90_ms", "p99_ms",
                "mean_ms", "req_per_s"} <= set(r)
        assert r["requests"] == 4 and r["errors"] == 0
        assert r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"]


@pytest.mark.parametrize("tool", sorted(TOOLS) + ["bench_serve"])
def test_tool_raises_without_cuda_unless_cpu(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv, _ = TOOLS.get(tool, (bench_serve.main, ["--image", __file__, "--root_dir",
                                                        str(tmp_path)], None))
    argv = [a for a in argv if a != "--cpu"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv)


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _phase17_results():
    """What chip_smoke.py's phase 17 reads from each tool: one passing
    record set per tool of its lanes."""
    import chip_smoke

    rec = {"card": CARD, "ms": 1.0}
    recs = {tool: [dict(rec)] for lane in chip_smoke.TOOL_LANES for tool, _ in lane}
    recs["bench_nms"] = [{**rec, "kind": "pallas_fp", "launches": 9},
                         {**rec, "kind": "iterative"}]
    recs["bench_int8_matmul"] = [{**rec, "launches": 13}, {**rec, "launches": 13}, dict(rec)]
    recs["bench_backbone"] = [{**rec, "launches": {"stem_fused": 12, "nms_fp": 0}}]
    recs["bench_serve"] = [{**rec, "concurrency": c, "requests": 16, "errors": 0}
                           for c in (1, 8)]
    recs["mem_report"] = [{**rec, "peak_allocated_gib": 6.2}]
    recs["bench_train"] = [{**rec, "optimizer_ms": -0.3, "differences": ["optimizer_ms"]}]
    return chip_smoke, recs


def _check(chip_smoke, recs, peak=6.5):
    results = {tool: (0, "".join(json.dumps(r) + "\n" for r in rs), "", 1.0)
               for tool, rs in recs.items()}
    with contextlib.redirect_stdout(io.StringIO()):
        return chip_smoke.check_tool_records(results, CARD, peak)


def test_phase17_checks_pass_good_records():
    chip_smoke, recs = _phase17_results()
    got = _check(chip_smoke, recs)
    assert got["launches"] == {"nms_fp": 9, "int8_matmul": 26, "stem_fused": 12}
    assert got["mem_report_vs_phase7"] == pytest.approx(6.2 / 6.5 - 1)


@pytest.mark.parametrize("fault", ["no card", "negative figure", "nan", "no nms launch",
                                   "one int8 mode", "serve error", "memory", "exit code"])
def test_phase17_checks_fail_each_fault(fault):
    chip_smoke, recs = _phase17_results()
    peak = 6.5
    if fault == "no card":
        del recs["bench_split"][0]["card"]
    elif fault == "negative figure":
        recs["bench_sweep"][0]["ms"] = -1.0
    elif fault == "nan":
        recs["bench_train"][0]["optimizer_ms"] = float("nan")
    elif fault == "no nms launch":
        recs["bench_nms"][0]["launches"] = 0
    elif fault == "one int8 mode":
        del recs["bench_int8_matmul"][1]["launches"]
    elif fault == "serve error":
        recs["bench_serve"][1]["errors"] = 1
    elif fault == "memory":
        peak = 5.0
    with pytest.raises(AssertionError):
        if fault == "exit code":
            with contextlib.redirect_stdout(io.StringIO()):
                chip_smoke.check_tool_records(
                    {t: (1, "", "boom", 1.0) for t in recs}, CARD, peak)
        else:
            _check(chip_smoke, recs, peak)
