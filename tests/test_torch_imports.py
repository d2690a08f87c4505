"""Import hygiene of the port: importing every module of
cl_object_detection_tpu_torch loads neither JAX nor the JAX package, and
starts no kernel build."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import cl_object_detection_tpu_torch as pkg
names = [pkg.__name__]
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
from cl_object_detection_tpu_torch import _build, native
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")),
    "jax_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "cl_object_detection_tpu"),
    "built": sorted(_build._libs),
    "native_loaded": native._lib is not None,
}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["modules"]) >= 66, got["modules"]
    assert {"cl_object_detection_tpu_torch.ops.quant",
            "cl_object_detection_tpu_torch.ops.int8_matmul",
            "cl_object_detection_tpu_torch.ops.focal_loss",
            "cl_object_detection_tpu_torch.il.losses",
            "cl_object_detection_tpu_torch.il.scail",
            "cl_object_detection_tpu_torch.il.weight_init",
            "cl_object_detection_tpu_torch.il.herding",
            "cl_object_detection_tpu_torch.il.prototype",
            "cl_object_detection_tpu_torch.il.pseudo_label",
            "cl_object_detection_tpu_torch.il.mas",
            "cl_object_detection_tpu_torch.il.agem",
            "cl_object_detection_tpu_torch.il.bic",
            "cl_object_detection_tpu_torch.models.expand",
            "cl_object_detection_tpu_torch.train.optim",
            "cl_object_detection_tpu_torch.train.state",
            "cl_object_detection_tpu_torch.train.step",
            "cl_object_detection_tpu_torch.states",
            "cl_object_detection_tpu_torch.data.coco",
            "cl_object_detection_tpu_torch.data.dataset",
            "cl_object_detection_tpu_torch.data.image_io",
            "cl_object_detection_tpu_torch.data.loader",
            "cl_object_detection_tpu_torch.data.transforms",
            "cl_object_detection_tpu_torch.models.convert",
            "cl_object_detection_tpu_torch.train.trainer",
            "cl_object_detection_tpu_torch.train.loop",
            "cl_object_detection_tpu_torch.cli.common",
            "cl_object_detection_tpu_torch.cli.train",
            "cl_object_detection_tpu_torch.utils.checkpoint",
            "cl_object_detection_tpu_torch.utils.recorder",
            "cl_object_detection_tpu_torch.utils.profiling",
            "cl_object_detection_tpu_torch.utils.toydata",
            "cl_object_detection_tpu_torch.native",
            "cl_object_detection_tpu_torch.eval.coco_eval",
            "cl_object_detection_tpu_torch.eval.evaluator",
            "cl_object_detection_tpu_torch.eval.report",
            "cl_object_detection_tpu_torch.cli.validate",
            "cl_object_detection_tpu_torch.cli.detect",
            "cl_object_detection_tpu_torch.ops.library",
            "cl_object_detection_tpu_torch.eval.deploy",
            "cl_object_detection_tpu_torch.cli.export",
            "cl_object_detection_tpu_torch.utils.notebook",
            "cl_object_detection_tpu_torch.utils.diagnostics"} <= set(got["modules"])
    assert got["jax"] == [], got["jax"]
    assert got["jax_package"] == [], got["jax_package"]
    assert got["built"] == []
    assert got["native_loaded"] is False


LIBRARY_PROBE = r"""
import json, sys
import torch
from cl_object_detection_tpu_torch.ops import library
from cl_object_detection_tpu_torch import _build
x4 = torch.zeros(1, 4, 4, 64)
k7 = torch.zeros(7, 7, 3, 64)
library.stem_fused_f32(x4, k7, torch.zeros(256))
library.stem_fused_bf16(x4.bfloat16(), torch.zeros(3, 3, 64, 256).bfloat16(), torch.zeros(256))
boxes, scores = torch.rand(1, 8, 4), torch.rand(1, 8)
library.nms_fp(boxes, scores, 0.5)
library.nms_iterative(boxes, scores, 0.5)
a, w = torch.ones(4, 16, dtype=torch.int8), torch.ones(2, 16, dtype=torch.int8)
library.int8_matmul(a, w, torch.ones(2), None, torch.float32)
library.int8_conv_nhwc(torch.ones(1, 3, 3, 16, dtype=torch.int8),
                       torch.ones(2, 144, dtype=torch.int8), torch.ones(2), None, 3, 1, 1,
                       torch.float32)
print(json.dumps({"package": sorted(m for m in sys.modules
                                   if m.startswith("cl_object_detection_tpu")),
                  "built": sorted(_build._libs)}))
"""


def test_op_library_imports_nothing_of_models():
    """The operator library, which a process that loads an exported
    artifact imports, and every operator's CPU implementation load
    nothing under ``models/`` (nor ``eval``, ``il``, ``train``) and build
    nothing."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", LIBRARY_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["built"] == []
    assert set(got["package"]) <= {
        "cl_object_detection_tpu_torch", "cl_object_detection_tpu_torch._build",
        "cl_object_detection_tpu_torch.ops", "cl_object_detection_tpu_torch.ops.library",
        "cl_object_detection_tpu_torch.ops.stem_fused", "cl_object_detection_tpu_torch.ops.pool",
        "cl_object_detection_tpu_torch.ops.nms", "cl_object_detection_tpu_torch.ops.nms_fp",
        "cl_object_detection_tpu_torch.ops.int8_matmul",
        "cl_object_detection_tpu_torch.ops.boxes"}, got["package"]


def test_port_never_loads_the_jax_packages_native_library():
    """The port's evaluator loads its own library from build/native/, not
    the JAX package's libcocoeval.so."""
    probe = (
        "import json\n"
        "from cl_object_detection_tpu_torch import native\n"
        "from cl_object_detection_tpu_torch.eval.coco_eval import CocoProtocolEval\n"
        "from cl_object_detection_tpu_torch.data.coco import CocoJson\n"
        "gt = CocoJson({'images': [{'id': 1, 'file_name': 'a', 'height': 9, 'width': 9}],\n"
        "               'annotations': [{'id': 1, 'image_id': 1, 'category_id': 1,\n"
        "                                'bbox': [0, 0, 4, 4], 'iscrowd': 0}],\n"
        "               'categories': [{'id': 1, 'name': 'x'}]})\n"
        "ap = CocoProtocolEval(gt, [1]).evaluate_class(\n"
        "    [{'image_id': 1, 'category_id': 1, 'bbox': [0, 0, 4, 4], 'score': 1.0}], 1)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps({'ap': ap, 'libs': sorted({l.split()[-1] for l in maps.splitlines()\n"
        "                                            if 'cocoeval' in l})}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ap"] == [1.0, 1.0]
    assert len(got["libs"]) == 1, got["libs"]
    assert "/build/native/libcocoeval-" in got["libs"][0]
    assert "cl_object_detection_tpu/native" not in got["libs"][0]


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names no JAX module and nothing of the JAX package."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "cl_object_detection_tpu"}, roots
    assert "cl_object_detection_tpu_torch" in roots
