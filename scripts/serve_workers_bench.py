#!/usr/bin/env python
"""--workers A/B: does the SO_REUSEPORT pre-fork pool raise serving
throughput on THIS host?

The single-process serving ceiling is host-side work — JSON parse,
feature assembly, detok — under one GIL (BASELINE.md "HTTP serving
under concurrent load": ~0.7 s of a 0.71 s batched wall is host).  A
pre-fork pool gives each worker its own GIL/process; on a multi-core
host that is N host pipelines.  This script measures workers=1 vs
workers=2 on a deliberately host-dominated configuration (small CPU
artifact + JSON bodies, so device compute is negligible and the host
path is the bottleneck under test), same client pool, and reports the
honest ratio — on a 1-core host the expectation is ~1.0x (the kernel
time-slices one core), which is the point: the lever is real cores,
and the A/B proves the pool works without misattributing wins.

Usage: python scripts/serve_workers_bench.py [n_requests] [n_clients]
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import numpy as np


def _post(url, data):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _drive(base, bodies, n_clients):
    texts = [None] * len(bodies)
    it = iter(range(len(bodies)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            texts[i] = _post(base + "/decode?mode=greedy",
                             bodies[i])["text"]

    ts = [threading.Thread(target=worker) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0, texts


def main():
    n_requests = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_clients = int(sys.argv[2]) if len(sys.argv) > 2 else 16

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from conftest import make_tiny_experiment
    from ast_tpu.cli import export_model

    root = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "serve_workers_bench")
    shutil.rmtree(root, ignore_errors=True)
    exp = make_tiny_experiment(root)
    out = export_model.main(
        ["-m", exp, "--batch", "8", "--frames", "60",
         "--platforms", "cpu", "--dtype", "float32"])

    rng = np.random.RandomState(0)
    feats = [rng.randn(60, 13).astype(np.float32) for _ in range(16)]
    bodies = [json.dumps({"features": x.tolist()}).encode()
              for x in feats]
    bodies = [bodies[i % len(feats)] for i in range(n_requests)]

    results = {}
    for workers in (1, 2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        proc = subprocess.Popen(
            [sys.executable, "-m", "ast_tpu.cli.serve", "-d", out,
             "--port", str(port), "--workers", str(workers),
             "--batch-window-ms", "10"],
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        base = f"http://127.0.0.1:{port}"
        try:
            deadline = time.monotonic() + 120
            while True:
                try:
                    with urllib.request.urlopen(base + "/healthz",
                                                timeout=5) as r:
                        if json.loads(r.read())["ok"]:
                            break
                except Exception:
                    pass
                assert time.monotonic() < deadline
                time.sleep(0.5)
            _post(base + "/decode?mode=greedy", bodies[0])  # warm
            time.sleep(1.0)   # let every worker warm its artifact
            _drive(base, bodies[:8], 8)                     # warm all
            wall, texts = _drive(base, bodies, n_clients)
            results[workers] = (wall, n_requests / wall, texts)
            print(f"workers={workers}: {wall:6.2f}s  "
                  f"{n_requests / wall:8,.1f} utts/sec", flush=True)
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)

    same = sum(a == b for a, b in zip(results[1][2], results[2][2]))
    print(f"\nanswers identical: {same}/{n_requests}")
    print(f"workers 2 vs 1: {results[2][1] / results[1][1]:.2f}x "
          f"(host cores: {os.cpu_count()})")


if __name__ == "__main__":
    main()
