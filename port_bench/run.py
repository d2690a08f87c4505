"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and limits are found by name
(``registry.py``); its traffic's kind runs the set-up, the measured
window and the check; the cell's metrics are read by their readers
(``metrics/<name>.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``busy_s`` and ``window_s`` under ``--trace 1``), ``breakdown``
under ``--trace 1``, and last ``compared``: each number that decided
``correct`` beside its limit, which also close standard error.

It exits with a code other than 0, and prints no result, when there is
no CUDA device or fewer than the cell asks for, when the program cannot
be imported, or when JAX or the JAX package is loaded once the window
has closed. Build and kernel caches stay inside the checkout.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cl_object_detection_tpu")
# the program builds its kernels into build/torch_kernels/ itself; these
# keep any other cache of the toolchain in the checkout too, at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton_cache",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


class Context:
    """What a kind's ``run`` is given: the cell, the run's arguments, the
    device, and the helpers every kind shares."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device,
                 options: dict = None, t0: float = None):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.options = dict(options or {})
        self.t0 = T0 if t0 is None else t0

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def fresh_memory(self) -> None:
        """Drop what set-up left in the allocator and start the peak anew,
        so ``memory_peak`` is the program's."""
        import torch

        self.free()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    @contextlib.contextmanager
    def reference_precision(self):
        """float32 without TF32 for the reference and the weights' making."""
        import torch

        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def profile(self, rec: dict, step, iterations: int) -> None:
        """Trace ``iterations`` of ``step(i)`` into ``rec``: ``trace`` (the
        device's pass) and ``host_trace`` (with the host's operators)."""
        from port_bench import trace

        rec["trace"], rec["host_trace"] = trace.profile(step, iterations, self.sync)


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             options: dict = None, cell=None, t0: float = None) -> dict:
    """One run of a cell: the kind's record, its metrics and its check.
    ``device`` None means the card (and no card is an error); the CPU
    tests pass a CPU device, a smaller ``cell`` and ``options``."""
    import torch

    from port_bench import compare, registry

    cell = cell or registry.Cell(workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"port_bench: the cell {workload} needs {cell.chips} CUDA "
                             f"device(s); found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    ctx = Context(cell, seed, seconds, trace, torch.device(device), options, t0)
    rec = registry.kind(cell.traffic["kind"]).run(ctx)
    section = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in section:
        value = registry.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, compared = compare.judge(rec["numbers"], cell.limits)
    dev = ctx.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": rec["items"], "failed": rec["failed"],
           "metrics": metrics, "device": device_info}
    tr = rec.get("trace")
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": rec["host_trace"].idle_gaps(10)}
    out["compared"] = {k: [c["value"], c["limit"]] for k, c in compared.items()}
    out["_record"] = rec
    return out


def rank_worker(a) -> int:
    """Rank ``a.rank`` of a cell on several devices: its kind's ``run_rank``,
    on the cell that rank 0 wrote to ``a.share``; it prints nothing on
    standard output."""
    import types

    import torch

    from port_bench import registry

    spec = registry.load_json(Path(a.share) / "cell.json")
    cell = types.SimpleNamespace(name=a.workload, config=spec["config"],
                                 traffic=spec["traffic"], chips=a.world)
    device = torch.device(a.device, a.rank) if a.device == "cuda" else torch.device(a.device)
    ctx = Context(cell, a.seed, a.seconds, bool(a.trace), device, json.loads(a.options))
    registry.kind(cell.traffic["kind"]).run_rank(ctx, a.rank, a.world, a.rendezvous, a.share)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank other than 0 of a cell on several cards, started by rank 0's kind
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", help=argparse.SUPPRESS)
    ap.add_argument("--share", help=argparse.SUPPRESS)
    ap.add_argument("--options", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    for key, rel in CACHES.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    if a.rank:
        return rank_worker(a)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    out.pop("_record")
    bad = loaded_forbidden()
    if bad:
        print(f"port_bench: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, (value, limit) in out["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
