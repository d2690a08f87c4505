"""Discovery by name: everything a cell needs is found from the names in
``BENCHMARK.json``, one file each, so a later cell, configuration,
traffic mix or per-layer metric is a new file plus an entry there.

* a configuration: ``configs/<config>.json`` (the entry's ``file``);
* a traffic mix: ``traffic/<traffic>.json``, data only, naming the
  ``kind`` of generator that reads it;
* a kind of generator: ``kinds/<kind>.py`` with ``run(ctx) -> dict``;
* a cell's correctness limits: ``workloads/<workload>.json``;
* a metric's reader: ``metrics/<metric>.py`` with ``read(rec)``, which
  returns a number or None when its run has nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    key = "port_bench._found." + re.sub(r"\W", "_", str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str) -> ModuleType:
    return _module(HERE / "kinds" / f"{name}.py")


def reader(metric: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{metric}.py")


def metrics_of(bench: dict, workload: str, section: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    limits read from their files."""

    def __init__(self, name: str, root: Path = ROOT, bench: Optional[dict] = None):
        self.bench = bench if bench is not None else benchmark(root)
        self.entry = _by_name(self.bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = _by_name(self.bench["configs"], self.entry["config"], "config")
        self.config: Dict = load_json(root / cfg_entry["file"])
        self.traffic: Dict = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits: Dict[str, float] = load_json(HERE / "workloads" / f"{name}.json")["limits"]
        self.end_to_end = metrics_of(self.bench, name, "end_to_end")
        self.per_layer = metrics_of(self.bench, name, "per_layer")
