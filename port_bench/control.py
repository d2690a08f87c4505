"""Readings that the limits of ``correct`` are set from: a cell's run,
its control and its planted faults on many seeds in one process, each
run's compared numbers as one JSON line.

    python3 port_bench/control.py --workload <name> --variant sound \
        --seeds 1 2 3 --seconds 3 [--out readings.jsonl]

``--variant`` is ``sound`` (the program as it is), ``control`` (the
nearest precision below the configuration's, in the program's place) or
a planted fault of the cell's kind (``kinds/<kind>.py``'s ``variants``).
The benchmark's own runs never run these.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, variant: str, seeds, seconds: float, device=None, cell=None):
    """Yield one record per seed: the compared numbers, ``correct`` under
    the cell's limits, and the run's end-to-end metrics."""
    import torch

    from port_bench import registry
    from port_bench.run import run_cell

    cell = cell or registry.Cell(workload)
    options = {} if variant == "sound" else (
        registry.kind(cell.traffic["kind"]).variants(cell.traffic)[variant])
    for seed in seeds:
        out = run_cell(workload, seed, seconds, False, device=device, options=options,
                       cell=cell, t0=time.perf_counter())
        rec = out.pop("_record")
        yield {"workload": workload, "variant": variant, "seed": seed,
               "correct": out["correct"], "numbers": rec["numbers"],
               "details": rec.get("details"), "metrics": out["metrics"]}
        del out, rec
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="sound")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    for line in readings(a.workload, a.variant, a.seeds, a.seconds):
        text = json.dumps(line)
        print(text, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
