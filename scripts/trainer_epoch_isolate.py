#!/usr/bin/env python
"""Isolate the real-trainer epoch overhead, one compile session.

Variants (same NN instance, same compiled per-bucket programs):
  A. nn.train_epoch as shipped (prefetcher, host batches, bookkeeping)
  B. pre-staged: every device batch of the epoch is uploaded and
     blocked on FIRST, then the dispatch loop runs back-to-back calling
     the same nn._train_multi_step/_train_step, one sync at the end —
     no host assembly, no transfer, no prefetch in the timed region
  C. B + per-dispatch host work the real loop does (loss append etc.)

A-B = feeding cost (assembly + host->device transfer + prefetch waits
that compute could not hide).  B vs bench_epoch's model = whether the
TRAINER's compiled programs are themselves slower than the bench's
hand-built ones.

Usage: python scripts/trainer_epoch_isolate.py
(expects the corpus from scripts/trainer_epoch_bench.py)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax


def main():
    from ast_tpu.train.trainer import NN, _group_stream

    nn = NN(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "trainer_epoch_bench", "exp"))
    n_utts = 17306
    set_key = "syn_train"
    tcfg = nn.cfg.train
    B = tcfg["batch_size"]
    G = nn.steps_per_dispatch

    # ---- warm epoch: pays every compile, fills the feature cache ----
    t0 = time.perf_counter()
    nn.train_epoch(set_key, epoch=1)
    print(f"A cold: {time.perf_counter() - t0:8.2f}s", flush=True)

    for e in (2, 3):
        t0 = time.perf_counter()
        nn.train_epoch(set_key, epoch=e)
        dt = time.perf_counter() - t0
        print(f"A warm (epoch {e}): {dt:8.2f}s  {n_utts / dt:7.1f} "
              "utts/s", flush=True)

    # ---- stage the whole epoch on device --------------------------------
    def staged(epoch):
        gen = nn.data_loader.get_batch(
            B, set_key, train=True, labels=True, epoch=epoch,
            group_runs=G, tail_shrink=nn.tail_shrink)
        items = []
        for payload in map(nn._device_group, _group_stream(gen, G)):
            items.append(payload)
        jax.block_until_ready(
            [p["X"] for k, p in items if k == "multi"])
        return items

    t0 = time.perf_counter()
    items = staged(epoch=4)
    print(f"staging epoch on device: {time.perf_counter() - t0:8.2f}s "
          f"({len(items)} dispatch groups)", flush=True)

    def run_staged(items, with_bookkeeping):
        params, state, opt_state = nn.params, nn.state, nn.opt_state
        epoch_key = jax.random.PRNGKey(7)
        losses, sizes = [], []
        consumed = 0
        t0 = time.perf_counter()
        for kind, payload in items:
            if kind == "multi":
                params, state, opt_state, loss_vec = \
                    nn._train_multi_step(
                        params, state, opt_state, payload["X"],
                        payload["y"], payload["n_real"], epoch_key,
                        consumed, payload.get("frame_len"))
                consumed += G
                if with_bookkeeping:
                    losses.append(loss_vec)
                    sizes.extend(payload["sizes"])
            else:
                for batch in payload:
                    params, state, opt_state, loss = nn._train_step(
                        params, state, opt_state, batch["X"],
                        batch["y"], batch["n_real"], epoch_key,
                        consumed, batch.get("frame_len"))
                    consumed += 1
                    if with_bookkeeping:
                        losses.append(loss)
                        sizes.append(len(batch["utts"]))
        jax.block_until_ready(params)
        dt = time.perf_counter() - t0
        # keep nn's trees consistent for the next variant
        nn.params, nn.state, nn.opt_state = params, state, opt_state
        return dt

    # NOTE: donation — the staged batches are NOT donated (only args
    # 0..2 are), so re-running over the same staged items is safe.
    for tag, book in (("B staged", False), ("C staged+book", True)):
        dt = run_staged(items, book)
        print(f"{tag}: {dt:8.2f}s  {n_utts / dt:7.1f} utts/s",
              flush=True)

    # ---- reference: the bench model in this same session ---------------
    import bench
    dt, ups, sps = bench.bench_epoch(B=B, G=G)
    print(f"bench_epoch model: {dt:.2f}s  {ups:.1f} utts/s "
          "(same session)", flush=True)


if __name__ == "__main__":
    main()
