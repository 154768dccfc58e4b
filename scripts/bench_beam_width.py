#!/usr/bin/env python
"""Wide-beam benchmark: beam widths 5 / 8 / 16 (BASELINE config 4 names
"beam.py width 5-16") of the XLA while-loop beam decoder on the flagship
model, in bf16, on JAX's default device.

For each width: throughput in utterances per second over ``n_iters``
batches of ``B`` utterances (T=640 frames, stop=175).  Weights are
random, so the beams are near-tied and the tokens mean nothing; this
script times decoding, ``tests/test_plain_path.py`` checks its tokens.

Usage: python scripts/bench_beam_width.py [B] [n_iters]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def run_width(B, T, stop, N, K, n_iters):
    import bench
    from ast_tpu.ops import beam as beam_ops

    mcfg, params, state = bench._flagship()
    X, _ = bench._batch(B, T, 16)
    decode = beam_ops.make_beam_decoder(mcfg, N=N, K=K, stop_limit=stop,
                                        compute_dtype=jnp.bfloat16)
    jax.block_until_ready(decode(params, state, X))       # compile
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = decode(params, state, X)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    ups = n_iters * B / dt
    print(f"  N=K={N}: {ups:8.1f} utts/s ({dt / n_iters * 1000:7.1f} "
          f"ms/batch of {B})", flush=True)
    return ups


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    T, stop = 640, 175
    dev = jax.devices()[0]
    print(f"device={dev.platform}:{dev.device_kind} B={B} T={T} "
          f"stop={stop}")
    rates = {N: run_width(B, T, stop, N, N, n_iters) for N in (5, 8, 16)}
    print("\nsummary (utts/s):")
    for N, r in rates.items():
        print(f"  N=K={N:2d} {r:8.1f}")


if __name__ == "__main__":
    main()
