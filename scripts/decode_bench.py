#!/usr/bin/env python
"""Decode-path benchmarks: batched greedy and batched beam on the
flagship model (bf16, random weights) on JAX's default device."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def _rate(fn, B, n_iters):
    jax.block_until_ready(fn())                    # compile + warm
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = fn()
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return n_iters * B / dt, dt / n_iters * 1000


def main(B=32, T=640, stop=175, N=5, K=5, n_iters=10):
    import bench
    from ast_tpu.models import seq2seq
    from ast_tpu.ops import beam as beam_ops

    mcfg, params, state = bench._flagship()
    X, _ = bench._batch(B, T, 16)

    @jax.jit
    def greedy(params, state, X):
        return seq2seq.predict_greedy(
            params, state, mcfg, X, stop, jnp.bfloat16)[0]

    ups, ms = _rate(lambda: greedy(params, state, X), B, n_iters)
    print(f"greedy: {ups:8.1f} utts/s ({ms:6.1f} ms/batch of {B})",
          flush=True)
    decode = beam_ops.make_beam_decoder(
        mcfg, N=N, K=K, stop_limit=stop, compute_dtype=jnp.bfloat16)
    ups, ms = _rate(lambda: decode(params, state, X), B, n_iters)
    print(f"beam N={N} K={K}: {ups:8.1f} utts/s ({ms:6.1f} ms/batch of "
          f"{B})", flush=True)


if __name__ == "__main__":
    main()
