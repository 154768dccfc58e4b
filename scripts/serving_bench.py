"""Serving-artifact decode throughput on JAX's default device: f32 vs
int8 weights.

Exports the flagship greedy decode twice, with f32 weights and with
``--quantize int8`` weights (dequantized inside the artifact), writes and
reads each back through ``serving.save_artifact`` / ``load_artifact``,
then interleaves timed rounds of both on the device.  Validates that the
in-artifact dequant is loop-hoisted by XLA (int8 should cost nothing).
Usage: ``python scripts/serving_bench.py [n_rounds] [B] [T] [stop]
[pipe_depth]``.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import jax.numpy as jnp

    n_rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 640
    stop = int(sys.argv[4]) if len(sys.argv) > 4 else 175
    depth = int(sys.argv[5]) if len(sys.argv) > 5 else 4

    from __graft_entry__ import FLAGSHIP_MCFG
    from ast_tpu import serving
    from ast_tpu.models import seq2seq

    with open(os.path.join(REPO, "experiments", "es_en_20h",
                           "model_cfg.json")) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"]["dec_vocab_size"] = \
        FLAGSHIP_MCFG["rnn_config"]["dec_vocab_size"]
    params, state = seq2seq.init_model(jax.random.PRNGKey(0), mcfg)
    X = np.random.RandomState(0).randn(B, T, 13).astype(np.float32)
    out_dir = os.path.join(REPO, ".bench_data", "serving_bench")
    os.makedirs(out_dir, exist_ok=True)
    platform = jax.devices()[0].platform
    platform = "cuda" if platform == "gpu" else platform

    arts = {}
    for name, quant in (("f32", False), ("int8", True)):
        t0 = time.time()
        exp = serving.export_greedy(params, state, mcfg, B, T, stop,
                                    compute_dtype=jnp.bfloat16,
                                    platforms=(platform,), quantize=quant)
        path = os.path.join(out_dir, f"greedy_{name}.jaxexp")
        nbytes = serving.save_artifact(exp, path)
        arts[name] = (serving.load_artifact(path).call, nbytes)
        print(f"{name}: exported {nbytes:,} bytes "
              f"in {time.time() - t0:.0f}s", flush=True)

    outs = {}
    for name, (call, _) in arts.items():          # first call compiles
        t0 = time.time()
        outs[name] = np.asarray(call(X)[0])
        print(f"{name}: first call {time.time() - t0:.0f}s", flush=True)
    Xd = jax.block_until_ready(jax.device_put(X))
    same = (outs["int8"] == outs["f32"]).mean()
    print(f"int8 vs f32 token agreement: {same:.4f}", flush=True)

    # two timing disciplines per round:
    #  - sync: one call, block — the latency-bound client's view
    #  - pipe: ``depth`` calls in flight, one block — how a serving host
    #    keeps the device busy
    timings = {k: [] for k in arts}
    piped = {k: [] for k in arts}
    for r in range(n_rounds):
        for name, (call, _) in arts.items():
            t0 = time.perf_counter()
            jax.block_until_ready(call(Xd))
            timings[name].append(B / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            for _ in range(depth):
                out = call(Xd)
            jax.block_until_ready(out)
            piped[name].append(depth * B / (time.perf_counter() - t0))
            print(f"round {r} {name}: {timings[name][-1]:,.0f} sync  "
                  f"{piped[name][-1]:,.0f} pipe{depth} utts/sec",
                  flush=True)

    print()
    for name in arts:
        print(f"{name}: sync best {max(timings[name]):,.0f} "
              f"median {np.median(timings[name]):,.0f}  |  "
              f"pipe{depth} best {max(piped[name]):,.0f} "
              f"median {np.median(piped[name]):,.0f}  "
              f"bytes {arts[name][1]:,}")
    for metric, t in (("sync", timings), (f"pipe{depth}", piped)):
        print(f"int8/f32 {metric} median: "
              f"{np.median(t['int8']) / np.median(t['f32']):.3f}")


if __name__ == "__main__":
    main()
