#!/usr/bin/env python
"""Benchmark: training throughput (utterances/sec/device) on the flagship
es_en_20h model shape, on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "gpu", ...}.

The headline is the SHIPPED harness: ``NN.train_epoch`` over a synthetic
epoch shaped like the es_en_20h train split (``EPOCH_BUCKETS``: 20
duration buckets, 17,306 utterances) with the device feature cache,
B=32, 4 steps per dispatch and bf16 compute; the value is the median of
the warm epochs.  Beside it, a one-shape step model (B=32, T=640, U=48)
times the same train step in bf16 and in f32, and reports their ratio.

There is no fallback: without a GPU, or when any stage fails, the script
exits non-zero and prints no result.  ``--epoch`` times the hand-built
epoch model (``bench_epoch``) instead of the harness.
"""

import functools
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
METRIC = "fisher_es_en_20h_train_utts_per_sec_per_device"


def _flagship():
    from __graft_entry__ import FLAGSHIP_MCFG
    from ast_tpu.models import seq2seq

    key = jax.random.PRNGKey(0)
    params, state = seq2seq.init_model(key, FLAGSHIP_MCFG)
    return FLAGSHIP_MCFG, params, state


def _batch(B, T, U, V=1098, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, T, 13).astype(np.float32)
    y = rng.randint(4, V, (B, U)).astype(np.int32)
    y[:, 0] = 1
    y[:, -1] = 2
    return jnp.asarray(X), jnp.asarray(y)


def make_train_runner(B=32, T=640, U=48, compute_dtype=jnp.bfloat16,
                      steps_per_dispatch=1, moments_dtype=None):
    """Compile + warm a full train step (fwd+bwd+adam); return a
    ``run(n_steps) -> utts/sec`` closure.

    Shapes mirror the es_en_20h recipe (batch 32, bucket 8 of 20 at 80
    frames/bucket).  ``steps_per_dispatch=G>1`` scans G stacked batches
    inside one jitted call — the trainer's ``extras.steps_per_dispatch``
    configuration (bit-equivalent to G sequential steps,
    tests/test_multi_dispatch.py)."""
    from ast_tpu.models import seq2seq
    from ast_tpu.train.optimizer import build_optimizer

    mcfg, params, state = _flagship()
    opt_cfg = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
               "grad_noise_eta": 0, "freeze": []}
    if moments_dtype:
        opt_cfg["moments_dtype"] = moments_dtype
    opt, opt_state = build_optimizer(opt_cfg, params)
    X, y = _batch(B, T, U)
    key = jax.random.PRNGKey(0)
    G = steps_per_dispatch

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

    # RNG keys are derived in-graph from the call index, as the trainer
    # does; params/state/opt-state are donated like trainer.py's step
    if G > 1:
        Xs = jnp.broadcast_to(X, (G,) + X.shape)
        ys = jnp.broadcast_to(y, (G,) + y.shape)

        def multi(params, state, opt_state, i):
            keys = jax.random.split(jax.random.fold_in(key, i), G)

            def body(carry, inp):
                p, s, o = carry
                Xi, yi, ki = inp
                p, s, o, loss = step(p, s, o, Xi, yi, ki)
                return (p, s, o), loss

            (params, state, opt_state), losses = jax.lax.scan(
                body, (params, state, opt_state), (Xs, ys, keys))
            return params, state, opt_state, losses[-1]

        call = jax.jit(multi, donate_argnums=(0, 1, 2))
    else:
        def single(params, state, opt_state, i):
            return step(params, state, opt_state, X, y,
                        jax.random.fold_in(key, i))

        call = jax.jit(single, donate_argnums=(0, 1, 2))

    carry = [params, state, opt_state]
    for i in range(1 + max(1, 10 // G)):        # compile + warm-up
        *carry, loss = call(*carry, 1000 + i)
    loss.block_until_ready()

    def run(n_steps):
        n_calls = max(1, n_steps // G)
        t0 = time.perf_counter()
        for i in range(n_calls):
            p, s, o, loss = call(*carry, i)
            carry[:] = [p, s, o]
        loss.block_until_ready()
        return (n_calls * G * B) / (time.perf_counter() - t0)

    return run


def bench_train_step(n_steps=30, B=32, T=640, U=48,
                     compute_dtype=jnp.bfloat16, n_rounds=4):
    run = make_train_runner(B, T, U, compute_dtype)
    return max(run(n_steps) for _ in range(n_rounds))


# Real es_en_20h train-split composition — (bucket, n_utts, frames, U) —
# derived from the reference's fisher_20h.info (17,306 utterances;
# counts per 80-frame duration bucket; U = estimated max BPE target
# length per bucket, words x1.4 + GO/EOS, rounded up to 16).
EPOCH_BUCKETS = [
    (0, 1025, 80, 16), (1, 3516, 160, 16), (2, 2543, 240, 32),
    (3, 1939, 320, 32), (4, 1486, 400, 48), (5, 1188, 480, 48),
    (6, 932, 560, 64), (7, 736, 640, 80), (8, 674, 720, 64),
    (9, 603, 800, 64), (10, 550, 880, 64), (11, 505, 960, 64),
    (12, 420, 1040, 80), (13, 342, 1120, 80), (14, 277, 1200, 80),
    (15, 189, 1280, 96), (16, 138, 1360, 96), (17, 86, 1440, 80),
    (18, 63, 1520, 80), (19, 94, 1680, 96),
]


def bench_epoch(B=32, G=4, compute_dtype=jnp.bfloat16):
    """Train throughput over a full es_en_20h-shaped epoch modelled with
    hand-built jitted steps: every duration bucket at its real utterance
    count (EPOCH_BUCKETS), multi-step dispatch, bucket-major order (the
    grouped stream the trainer produces).  Returns (epoch_seconds,
    utts_per_sec, padded_slots_per_sec), best of 2 epochs after a warm
    epoch."""
    from ast_tpu.data.dataloader import FisherDataLoader
    from ast_tpu.models import seq2seq
    from ast_tpu.train.optimizer import build_optimizer

    mcfg, params, state = _flagship()
    opt_cfg = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
               "grad_noise_eta": 0, "freeze": []}
    opt, opt_state = build_optimizer(opt_cfg, params)
    base = jax.random.PRNGKey(0)

    def make_step(T, U, rows, g):
        X, y = _batch(rows, T, U)
        Xs = jnp.broadcast_to(X, (g,) + X.shape)
        ys = jnp.broadcast_to(y, (g,) + y.shape)

        @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
        def multi(params, state, opt_state, i):
            keys = jax.random.split(jax.random.fold_in(base, i), g)

            def body(carry, inp):
                p, s, o = carry
                Xi, yi, ki = inp

                def loss_fn(pp):
                    return seq2seq.forward_loss(
                        pp, s, mcfg, Xi, yi, ki, train=True,
                        teach_ratio=0.8, add_noise=0.25,
                        compute_dtype=compute_dtype)

                (loss, ns), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(p)
                upd, o2 = opt.update(grads, o, p)
                p = jax.tree.map(lambda a, u: a + u, p, upd)
                return (p, ns, o2), loss

            carry, losses = jax.lax.scan(
                body, (params, state, opt_state), (Xs, ys, keys))
            return carry + (losses[-1],)

        return multi

    # the trainer's dispatch plan per bucket: full batches ride G-step
    # dispatches, the remainder run as singles, and the last partial
    # batch pads only to dataloader.tail_rows (shrink_tail_batches)
    plan = []  # (step_fn, n_dispatches) per bucket piece
    total_utts = 0
    total_slots = 0
    for b, n, T, U in EPOCH_BUCKETS:
        n_full, n_tail = divmod(n, B)
        pieces = []  # (rows, g, n_disp)
        if n_full // G:
            pieces.append((B, G, n_full // G))
        if n_full % G:
            pieces.append((B, 1, n_full % G))
        if n_tail:
            pieces.append((FisherDataLoader.tail_rows(n_tail, B, 8), 1, 1))
        for rows, g, n_disp in pieces:
            plan.append((make_step(T, U, rows, g), n_disp))
            total_slots += n_disp * g * rows
        # real utterances (the trainer's accounting); the device runs
        # the padded slot count, reported separately
        total_utts += n

    def one_epoch(p, s, o):
        t0 = time.perf_counter()
        loss = None
        for i, (step, n_disp) in enumerate(plan):
            for j in range(n_disp):
                p, s, o, loss = step(p, s, o, i * 1000 + j)
        loss.block_until_ready()
        return p, s, o, time.perf_counter() - t0

    p, s, o, _ = one_epoch(params, state, opt_state)   # compile epoch
    best = float("inf")
    for _ in range(2):
        p, s, o, dt = one_epoch(p, s, o)
        best = min(best, dt)
    return best, total_utts / best, total_slots / best


def bench_real_trainer(root=None, warm_epochs=3):
    """Drive the SHIPPED ``NN.train_epoch`` (hbm_cache, B=32 G=4, bf16)
    over the es_en_20h-shaped synthetic corpus.  Returns (warm epoch
    utts/sec list, utterances per epoch); epoch 1 (compiles + cache
    upload) is not counted."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from trainer_epoch_bench import (DEFAULT_ROOT, build_corpus,
                                     write_configs)
    from ast_tpu.train.trainer import NN

    root = root or DEFAULT_ROOT
    n_utts = build_corpus(root, log=lambda *a, **k: None)
    exp = write_configs(root, 32, 4, hbm_cache=True)
    nn = NN(exp)
    rates = []
    for e in range(1, warm_epochs + 2):
        t0 = time.perf_counter()
        nn.train_epoch("syn_train", epoch=e)
        dt = time.perf_counter() - t0
        if e > 1:
            rates.append(n_utts / dt)
    return rates, n_utts


def device_fields():
    """The payload's device identification; fails without a GPU."""
    from ast_tpu.utils.device import nvidia_smi, require_gpu

    dev = require_gpu()
    raw, cards = nvidia_smi()
    return {"device": dev, "gpu": cards[0], "nvidia_smi": raw}


def train_payload(dev, trainer_rates, trainer_n, bf16_ups, f32_ups):
    """The result JSON: headline = median warm ``NN.train_epoch`` epoch;
    the one-shape step model's bf16 and f32 rates beside it."""
    if not trainer_rates:
        raise ValueError("no warm NN.train_epoch epoch was measured")
    med = float(np.median(trainer_rates))
    return {
        "metric": METRIC,
        "value": med,
        "unit": "utts/sec/device",
        **dev,
        "config": (f"NN.train_epoch: 20-bucket es_en_20h-shaped epoch "
                   f"({trainer_n} utts), B=32 G=4, bf16 + hbm_cache; "
                   "median of warm epochs"),
        "trainer_epochs_utts_per_sec": list(trainer_rates),
        "trainer_epoch_seconds": trainer_n / med,
        "step_model": {
            "shape": "B=32 T=640 U=48",
            "bf16_utts_per_sec": bf16_ups,
            "f32_utts_per_sec": f32_ups,
            "bf16_vs_f32": bf16_ups / f32_ups,
        },
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from ast_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = device_fields()
    if "--epoch" in argv:
        dt, ups, sps = bench_epoch()
        print(json.dumps({
            "metric": "fisher_es_en_20h_full_epoch_train",
            "value": ups, "unit": "utts/sec/device", **dev,
            "padded_slots_per_sec": sps, "epoch_seconds": dt,
            "config": "epoch model: 20-bucket duration mix, B=32, G=4, "
                      "bf16"}))
        return
    run_bf16 = make_train_runner(steps_per_dispatch=4)
    bf16 = max(run_bf16(32) for _ in range(3))
    run_f32 = make_train_runner(compute_dtype=jnp.float32,
                                steps_per_dispatch=4)
    f32 = max(run_f32(32) for _ in range(3))
    rates, n = bench_real_trainer()
    print(json.dumps(train_payload(dev, rates, n, bf16, f32)))


if __name__ == "__main__":
    main()
