#!/usr/bin/env python
"""Decompose the flagship train step's device time (JAX's default
device).

Times jitted sub-programs with interleaved rounds and min-of-rounds:
full step, loss fwd, fwd+bwd (no opt), opt.update alone, conv
front-end alone, the encoder alone, and a trivial dispatch.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def timeit(fns, n_iters=30, rounds=4):
    best = {k: 1e9 for k in fns}
    for _ in range(rounds):
        for k, f in fns.items():
            f()  # warm
            t0 = time.perf_counter()
            for _ in range(n_iters):
                out = f()
            jax.block_until_ready(out)
            best[k] = min(best[k],
                          (time.perf_counter() - t0) / n_iters * 1000)
    return best


def main(B=32, T=640, U=48):
    import bench
    from ast_tpu.models import seq2seq
    from ast_tpu.ops.cnn import conv_frontend
    from ast_tpu.train.optimizer import build_optimizer

    mcfg, params, state = bench._flagship()
    X, y = bench._batch(B, T, U)
    cd = jnp.bfloat16
    opt_cfg = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
               "grad_noise_eta": 0, "freeze": []}
    opt, opt_state = build_optimizer(opt_cfg, params)
    key = jax.random.PRNGKey(0)

    def loss_fn(p, s):
        return seq2seq.forward_loss(
            p, s, mcfg, X, y, key, train=True, teach_ratio=0.8,
            add_noise=0.25, compute_dtype=cd)

    @jax.jit
    def full_step(p, s, o):
        (loss, ns), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, s)
        upd, o2 = opt.update(grads, o, p)
        p2 = jax.tree.map(lambda a, u: a + u, p, upd)
        return loss, p2, ns, o2

    @jax.jit
    def fwd_only(p, s):
        return loss_fn(p, s)[0]

    @jax.jit
    def fwd_bwd(p, s):
        (loss, _), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, s)
        return loss, grads

    (_, grads0) = fwd_bwd(params, state)
    grads0 = jax.tree.map(jnp.array, grads0)

    @jax.jit
    def opt_only(g, o, p):
        upd, o2 = opt.update(g, o, p)
        return jax.tree.map(lambda a, u: a + u, p, upd), o2

    @jax.jit
    def conv_only(p, s):
        h, _ = conv_frontend(p["cnn"], s["cnn_bn"],
                             mcfg["cnn_config"], X, True, cd)
        return jnp.sum(h)

    @jax.jit
    def encode_only(p, s):
        enc, h0, c0, _ = seq2seq.encode(p, s, mcfg, X, key, True, 0.25,
                                        cd)
        return jnp.sum(enc) + jnp.sum(h0)

    @jax.jit
    def trivial(x):
        return x + 1.0

    one = jnp.ones(())
    res = timeit({
        "full_step": lambda: full_step(params, state, opt_state)[0],
        "fwd_only": lambda: fwd_only(params, state),
        "fwd_bwd": lambda: fwd_bwd(params, state)[0],
        "opt_only": lambda: opt_only(grads0, opt_state, params
                                     )[0]["dec"]["out_b"],
        "conv_only": lambda: conv_only(params, state),
        "encode_only": lambda: encode_only(params, state),
        "dispatch_floor": lambda: trivial(one),
    })
    print(f"B={B} T={T} U={U} (ms, min over rounds):")
    for k, v in res.items():
        print(f"  {k:>16}: {v:7.2f}")


if __name__ == "__main__":
    main(B=32)
    main(B=128)
