"""A/B the device cost of in-graph SpecAugment in the full train step.

Claim under test: because the masks are a handful of static-shape
elementwise ops fused into a step dominated by the LSTM recurrence,
enabling ``data.spec_augment`` costs ~nothing per step.  Same
interleaved methodology as scripts/moments_ab.py: alternate (SA off, SA
on) rounds so drifts of the device's speed hit both arms equally, report
per-arm median utts/sec.

Usage:  python scripts/specaugment_cost.py [--rounds 6] [--batch 128]
"""

import argparse
import statistics
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def make_runner(B, G, sa_cfg):
    """bench.make_train_runner's flagship step, with optional in-graph
    SpecAugment applied exactly where the trainer applies it (before
    forward_loss, key split from the step key)."""
    import bench
    from ast_tpu.models import seq2seq
    from ast_tpu.ops.specaugment import spec_augment
    from ast_tpu.train.optimizer import build_optimizer

    T, U = 640, 48
    mcfg, params, state = bench._flagship()
    opt, opt_state = build_optimizer(
        {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
         "grad_noise_eta": 0, "freeze": []}, params)
    X, y = bench._batch(B, T, U)
    key = jax.random.PRNGKey(0)

    def step(params, state, opt_state, X, y, rng):
        if sa_cfg is not None:
            rng, sa_key = jax.random.split(rng)
            X = spec_augment(sa_key, X, sa_cfg)

        def loss_fn(p):
            return seq2seq.forward_loss(
                p, state, mcfg, X, y, rng, train=True, teach_ratio=0.8,
                add_noise=0.25, compute_dtype=jnp.bfloat16)

        (loss, new_state), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_state, opt_state, loss

    Xs = jnp.broadcast_to(X, (G,) + X.shape)
    ys = jnp.broadcast_to(y, (G,) + y.shape)

    def multi(params, state, opt_state, i):
        keys = jax.random.split(jax.random.fold_in(key, i), G)

        def body(carry, inp):
            p, s, o = carry
            Xb, yb, k = inp
            p, s, o, loss = step(p, s, o, Xb, yb, k)
            return (p, s, o), loss

        (params, state, opt_state), losses = jax.lax.scan(
            body, (params, state, opt_state), (Xs, ys, keys))
        return params, state, opt_state, losses

    fn = jax.jit(multi, donate_argnums=(0, 1, 2))
    p, s, o, l = fn(params, state, opt_state, 0)  # compile + warm
    jax.block_until_ready(l)
    box = [p, s, o]

    def run(n_dispatch):
        t0 = time.perf_counter()
        loss = None
        for i in range(n_dispatch):
            box[0], box[1], box[2], loss = fn(box[0], box[1], box[2], i)
        jax.block_until_ready(loss)
        dt = time.perf_counter() - t0
        return n_dispatch * G * B / dt

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dispatches", type=int, default=20)
    args = ap.parse_args()

    sa = {"freq_masks": 2, "freq_width": 6, "time_masks": 2,
          "time_width": 40}
    run_off = make_runner(args.batch, 4, None)
    run_on = make_runner(args.batch, 4, sa)

    off, on = [], []
    for r in range(args.rounds):
        off.append(run_off(args.dispatches))
        on.append(run_on(args.dispatches))
        print(f"round {r}: off {off[-1]:.0f}  on {on[-1]:.0f} utts/sec",
              flush=True)

    m_off = statistics.median(off)
    m_on = statistics.median(on)
    print(f"\nmedian off {m_off:.0f}  on {m_on:.0f} utts/sec  "
          f"(on/off = {m_on / m_off:.3f})")


if __name__ == "__main__":
    main()
