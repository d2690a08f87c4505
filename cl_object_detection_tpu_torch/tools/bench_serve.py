"""Serving latency under load (the JAX package's ``tools/bench_serve.py``):
start the port's ``cli.serve`` as a child process, wait for ``/healthz``,
then, per concurrency level, that many client threads POST the same
image to ``/detect`` over keep-alive connections; one JSON record per
level with the latency percentiles, the mean and the requests per second.

    python -m cl_object_detection_tpu_torch.tools.bench_serve --image img.png \\
        (--root_dir run --scenario 20 [--state 0 --epoch -1] | --from_export art \\
         | --weights w.npz --params_json params.json) \\
        [--concurrency 1 8 16] [--requests 64] [--max_batch 8] [--cpu] [server flags ...]

Flags this tool does not know (``--nms_impl``, ``--quantize``, ...) go to
``cli.serve`` unchanged. The server micro-batches (``--max_batch``, a 5 ms
window), so at concurrency C one device call serves up to min(C,
max_batch) requests. The child is stopped through its handle, never by a
pattern, on every exit path.
"""
from __future__ import annotations

import argparse
import http.client
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

from ..utils import benchlib
from . import common


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_healthy(port: int, proc: subprocess.Popen, timeout: float) -> float:
    """Seconds until ``/healthz`` answers 200; raises if the server exits
    or the timeout passes."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited early (rc={proc.returncode})")
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            c.request("GET", "/healthz")
            if c.getresponse().status == 200:
                return time.perf_counter() - t0
        except OSError:
            time.sleep(0.25)
    raise TimeoutError("server never became healthy")


def fire(port: int, payload: bytes, n: int, lat: list, errs: list) -> None:
    """One client: ``n`` sequential requests over a keep-alive connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    for _ in range(n):
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/detect", body=payload,
                         headers={"Content-Type": "application/octet-stream"})
            r = conn.getresponse()
            body = r.read()
            if r.status != 200:
                errs.append(f"HTTP {r.status}")
                continue
            json.loads(body)
            lat.append(time.perf_counter() - t0)
        except (OSError, http.client.HTTPException, ValueError) as e:
            errs.append(type(e).__name__)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.close()


def pctl(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def level(port: int, payload: bytes, conc: int, requests: int) -> dict:
    per = max(1, requests // conc)
    lat: list = []
    errs: list = []
    threads = [threading.Thread(target=fire, args=(port, payload, per, lat, errs))
               for _ in range(conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    out = {"metric": "serve_detect_latency", "concurrency": conc, "requests": len(lat),
           "errors": len(errs)}
    if errs:
        out["error_kinds"] = sorted(set(errs))
    if lat:
        out.update(p50_ms=pctl(lat, 50) * 1e3, p90_ms=pctl(lat, 90) * 1e3,
                   p99_ms=pctl(lat, 99) * 1e3, mean_ms=statistics.mean(lat) * 1e3,
                   req_per_s=len(lat) / wall)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image", required=True, help="request body (PNG, or JPEG with cv2/PIL)")
    ap.add_argument("--root_dir", default=None, help="a run of the port's trainer")
    ap.add_argument("--scenario", nargs="+", default=None)
    ap.add_argument("--state", default=None)
    ap.add_argument("--epoch", default=None)
    ap.add_argument("--from_export", default=None, help="a cli.export artifact directory")
    ap.add_argument("--port", type=int, default=0, help="0: a free port")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per concurrency level")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--startup_timeout", type=float, default=600.0)
    common.add_device_flag(ap)
    a, server_flags = ap.parse_known_args(argv)
    if not (a.root_dir or a.from_export or "--weights" in server_flags):
        ap.error("give --root_dir, --from_export or --weights")
    device = common.device_of(a)
    with open(a.image, "rb") as f:
        payload = f.read()
    port = a.port or free_port()
    cmd = [sys.executable, "-m", "cl_object_detection_tpu_torch.cli.serve",
           "--port", str(port), "--max_batch", str(a.max_batch)]
    for flag in ("root_dir", "state", "epoch", "from_export"):
        if getattr(a, flag) is not None:
            cmd += [f"--{flag}", str(getattr(a, flag))]
    if a.scenario:
        cmd += ["--scenario", *a.scenario]
    cmd += server_flags + (["--cpu"] if a.cpu else [])
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            try:
                start_s = wait_healthy(port, proc, a.startup_timeout)
            except (RuntimeError, TimeoutError):
                proc.kill()
                proc.wait()
                log.seek(0)
                raise RuntimeError("cli.serve did not come up:\n"
                                   + log.read().decode(errors="replace")[-3000:])
            fire(port, payload, a.warmup, [], [])
            for conc in a.concurrency:
                benchlib.emit({**level(port, payload, conc, a.requests),
                               "server_start_s": start_s}, device)
        finally:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


if __name__ == "__main__":
    main()
