#!/usr/bin/env python
"""Performance sweep over train-step variants on JAX's default device.

Usage: python scripts/perf_sweep.py [--steps N]
Prints utts/sec for each (unroll, dtype, batch) combination.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def measure(B, T, U, unroll, dtype_name, n_steps=20):
    from __graft_entry__ import FLAGSHIP_MCFG
    from ast_tpu.models import seq2seq
    from ast_tpu.train.optimizer import build_optimizer

    mcfg = jax.tree.map(lambda x: x, FLAGSHIP_MCFG)
    mcfg["rnn_config"] = dict(mcfg["rnn_config"], scan_unroll=unroll)
    compute_dtype = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32

    key = jax.random.PRNGKey(0)
    params, state = seq2seq.init_model(key, mcfg)
    opt_cfg = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
               "grad_noise_eta": 0, "freeze": []}
    opt, opt_state = build_optimizer(opt_cfg, params)

    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.randn(B, T, 13), jnp.float32)
    y = rng.randint(4, 1098, (B, U)).astype(np.int32)
    y[:, 0] = 1
    y[:, -1] = 2
    y = jnp.asarray(y)

    @jax.jit
    def step(params, state, opt_state, X, y, rng):
        def loss_fn(p):
            return seq2seq.forward_loss(
                p, state, mcfg, X, y, rng, train=True,
                teach_ratio=0.8, add_noise=0.25,
                compute_dtype=compute_dtype)

        (loss, new_state), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_state, opt_state, loss

    t0 = time.perf_counter()
    params, state, opt_state, loss = step(params, state, opt_state, X, y, key)
    loss.block_until_ready()
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(n_steps):
        params, state, opt_state, loss = step(
            params, state, opt_state, X, y, jax.random.fold_in(key, i))
    loss.block_until_ready()
    dt = time.perf_counter() - t0
    ups = n_steps * B / dt
    print(f"B={B:4d} T={T} U={U} unroll={unroll} {dtype_name}: "
          f"{ups:8.1f} utts/s  ({dt/n_steps*1000:6.1f} ms/step, "
          f"compile {compile_time:.0f}s, loss {float(loss):.1f})",
          flush=True)
    return ups


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--quick", action="store_true")
    args = p.parse_args()

    combos = [
        (32, 640, 48, 1, "bf16"),
        (32, 640, 48, 1, "f32"),
        (32, 640, 48, 4, "bf16"),
        (64, 640, 48, 1, "bf16"),
        (128, 640, 48, 1, "bf16"),
    ]
    if args.quick:
        combos = combos[:2]
    for B, T, U, unroll, dt in combos:
        measure(B, T, U, unroll, dt, args.steps)
