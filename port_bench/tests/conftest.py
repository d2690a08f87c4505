"""Shared helpers of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (the widths stay; the frame, batch and ring shrink)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import registry  # noqa: E402

SMALL_PREDICT = dict(frame=[64, 96], image=[64, 90], batch=2, ring=2, check_batches=3,
                     trace_batches=2)
SMALL_TRAIN = dict(frame=[64, 96], image=[64, 90], batch=2, ring=6, box_side=[16, 48])


# the data axis's cell, proven on four cards but not in BENCHMARK.json yet
# (PERF.md, Open questions): its files are in port_bench/ for a later PR
DATA_AXIS = {"name": "r101-train-s1-dp4", "config": "retinanet-r101-fpn-voc",
             "traffic": "train-s1-distill-dp4", "chips": 4,
             "why": "r101-train-s1-b16 on 4 cards over NCCL, global batch 64"}


def bench_with_data_axis() -> dict:
    bench = registry.benchmark()
    if all(w["name"] != DATA_AXIS["name"] for w in bench["workloads"]):
        bench["workloads"] = bench["workloads"] + [DATA_AXIS]
    return bench


def small_cell(name: str, **config):
    """The cell ``name`` at a CPU-sized frame and batch; ``config``
    overrides keys of its configuration (the R101 runs as an R50 here)."""
    cell = registry.Cell(name, bench=bench_with_data_axis())
    train = cell.traffic["kind"].startswith("train")
    cell.traffic.update(SMALL_TRAIN if train else SMALL_PREDICT)
    if train:
        cell.config.update(depth=50)
    cell.config.update(config)
    return cell


@pytest.fixture
def cell_at_small_size():
    return small_cell
