"""HTTP serving throughput under concurrent load: micro-batching A/B.

Measures what ``serve.py --batch-window-ms`` buys on the device:
exports one flagship-shaped greedy artifact, starts the HTTP server
twice (window off / window on), and fires the same pool of concurrent
clients at both.  Without batching every request pays a full
static-batch device call (B-1 padding rows of waste); with a window,
concurrent requests ride the same call, so sustained throughput should
approach the artifact's raw batch decode rate.

Usage: ``python scripts/serve_load_bench.py [n_requests] [n_clients]
[B] [T] [stop] [window_ms]``.

The reference has no serving path at all (decode = the research CLI,
reference: beam.py:45-147); this measures a new capability.
"""

import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _post(url, data,
          ctype="application/json"):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _drive(base, bodies, n_clients, ctype="application/json",
           path="/decode"):
    """Fire all pre-encoded request bodies from a pool of n_clients
    threads; returns (wall_seconds, texts in request order)."""
    texts = [None] * len(bodies)
    it = iter(range(len(bodies)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            texts[i] = _post(base + path, bodies[i], ctype)["text"]

    ts = [threading.Thread(target=worker) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0, texts


def main():
    import jax
    import jax.numpy as jnp

    n_requests = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_clients = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    # one bucket width of frames: short telephone utterances keep the
    # per-request JSON cost (client, server and detok share the host's
    # cores) from masking the device-call saving under test
    T = int(sys.argv[4]) if len(sys.argv) > 4 else 80
    stop = int(sys.argv[5]) if len(sys.argv) > 5 else 175
    window_ms = float(sys.argv[6]) if len(sys.argv) > 6 else 30.0

    from __graft_entry__ import FLAGSHIP_MCFG
    from ast_tpu import serving
    from ast_tpu.cli import serve
    from ast_tpu.models import seq2seq

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "experiments", "es_en_20h",
            "model_cfg.json")) as f:
        mcfg = json.load(f)
    vocab_size = FLAGSHIP_MCFG["rnn_config"]["dec_vocab_size"]
    mcfg["rnn_config"]["dec_vocab_size"] = vocab_size
    params, state = seq2seq.init_model(jax.random.PRNGKey(0), mcfg)

    platform = jax.devices()[0].platform
    platform = "cuda" if platform == "gpu" else platform
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "serve_load_bench")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    exp = serving.export_greedy(params, state, mcfg, B, T, stop,
                                compute_dtype=jnp.bfloat16,
                                platforms=(platform,))
    fname = f"greedy_B{B}_T{T}.jaxexp"
    nbytes = serving.save_artifact(exp, os.path.join(out_dir, fname))
    entry = {"file": fname, "kind": "greedy", "batch": B,
             "frames": T, "platforms": [platform], "bytes": nbytes}
    serving.write_manifest(
        out_dir, [entry],
        mcfg, stop, "bfloat16",
        i2w={i: f"w{i}" for i in range(vocab_size)}, dec_key="en_w")
    print(f"exported {fname} ({nbytes:,} bytes, platform={platform}) "
          f"in {time.time() - t0:.0f}s", flush=True)

    import io
    rng = np.random.RandomState(0)
    feats = [rng.randn(T, 13).astype(np.float32)
             for _ in range(min(n_requests, 16))]
    bodies = [json.dumps({"features": x.tolist(),
                          "mode": "greedy"}).encode() for x in feats]

    def _npy(x):
        buf = io.BytesIO()
        np.save(buf, x)
        return buf.getvalue()

    npy_bodies = [_npy(x) for x in feats]
    idx = [i % len(feats) for i in range(n_requests)]
    bodies = [bodies[i] for i in idx]
    npy_bodies = [npy_bodies[i] for i in idx]
    print(f"body bytes: json {len(bodies[0]):,}  "
          f"npy {len(npy_bodies[0]):,}", flush=True)

    results = {}
    # (label, window_ms, request bodies, content type)
    arms = (("unbatched", 0.0, bodies, "application/json"),
            ("batched", window_ms, bodies, "application/json"),
            ("batched+npy", window_ms, npy_bodies,
             "application/octet-stream"))
    for label, window, reqs, ctype in arms:
        httpd, state_srv = serve.make_server(out_dir, port=0,
                                             batch_window_ms=window)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{port}"
        try:
            _post(base + "/decode?mode=greedy", reqs[0], ctype)  # warm
            wall, texts = _drive(base, reqs, n_clients, ctype,
                                 "/decode?mode=greedy")
            results[label] = (wall, n_requests / wall, texts)
            print(f"{label:11s} (window {window:g} ms): {wall:6.2f}s  "
                  f"{n_requests / wall:8,.1f} utts/sec", flush=True)
        finally:
            httpd.shutdown()
            if state_srv.batcher is not None:
                state_srv.batcher.close()

    # bulk arm: ONE request = one full static batch via /decode_batch
    # (binary (B, T, F) stack) — no window, no request concurrency
    # needed; a few clients keep calls pipelined across the window
    # the server spends in host postprocess
    stacks = [np.stack([feats[i] for i in idx[c: c + B]])
              for c in range(0, n_requests, B)]
    bulk_bodies = [_npy(s) for s in stacks]
    print(f"bulk body bytes: {len(bulk_bodies[0]):,} "
          f"({B} utts/request)", flush=True)
    httpd, state_srv = serve.make_server(out_dir, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    try:
        _post(base + "/decode_batch?mode=greedy", bulk_bodies[0],
              "application/octet-stream")                       # warm
        chunks = [None] * len(bulk_bodies)
        it = iter(range(len(bulk_bodies)))
        lock = threading.Lock()

        def bulk_worker():
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                out = _post(base + "/decode_batch?mode=greedy",
                            bulk_bodies[i], "application/octet-stream")
                chunks[i] = [r.get("text") for r in out["results"]]

        ts = [threading.Thread(target=bulk_worker) for _ in range(4)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        bulk_texts = [t for c in chunks for t in c]
        results["bulk"] = (wall, n_requests / wall, bulk_texts)
        print(f"{'bulk':11s} (1 req = {B} utts): {wall:6.2f}s  "
              f"{n_requests / wall:8,.1f} utts/sec", flush=True)
    finally:
        httpd.shutdown()

    failed = sum(t is None for mode in results.values() for t in mode[2])
    same = sum(a == b == c == d and a is not None
               for a, b, c, d in zip(results["unbatched"][2],
                                     results["batched"][2],
                                     results["batched+npy"][2],
                                     results["bulk"][2]))
    print(f"\nanswers identical across modes: {same}/{n_requests}"
          + (f"  (FAILED requests: {failed})" if failed else ""))
    print(f"micro-batching speedup: "
          f"{results['batched'][1] / results['unbatched'][1]:.2f}x "
          f"({n_clients} concurrent clients, batch {B}, "
          f"window {window_ms:g} ms)")
    print(f"npy-body speedup over json (batched): "
          f"{results['batched+npy'][1] / results['batched'][1]:.2f}x")
    print(f"bulk /decode_batch speedup over batched+npy: "
          f"{results['bulk'][1] / results['batched+npy'][1]:.2f}x")


if __name__ == "__main__":
    main()
