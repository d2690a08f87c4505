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
from cl_object_detection_tpu_torch import _build
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")),
    "jax_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "cl_object_detection_tpu"),
    "built": sorted(_build._libs),
}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["modules"]) >= 32, got["modules"]
    assert {"cl_object_detection_tpu_torch.ops.quant",
            "cl_object_detection_tpu_torch.ops.int8_matmul",
            "cl_object_detection_tpu_torch.ops.focal_loss",
            "cl_object_detection_tpu_torch.il.losses",
            "cl_object_detection_tpu_torch.train.optim",
            "cl_object_detection_tpu_torch.train.state",
            "cl_object_detection_tpu_torch.train.step"} <= set(got["modules"])
    assert got["jax"] == [], got["jax"]
    assert got["jax_package"] == [], got["jax_package"]
    assert got["built"] == []
