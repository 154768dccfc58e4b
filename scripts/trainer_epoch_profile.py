#!/usr/bin/env python
"""Decompose a warm NN.train_epoch: where does the wall time go?

Wraps the shipped trainer's jitted-step attributes and the Prefetcher
queue with timers (no behavior change) and runs warm epochs over the
flagship-shaped corpus from trainer_epoch_bench, reporting:

  dispatch_issue   time the epoch loop spent INSIDE the jitted-call
                   python frames (async issue + any implicit sync)
  prefetch_wait    time blocked on the prefetch queue (host assembly /
                   host->device staging not hidden behind compute)
  other            epoch bookkeeping + the final device sync (the
                   actual compute drains here if issue was async)

Usage: python scripts/trainer_epoch_profile.py [--epochs 3]
(expects the corpus+configs from scripts/trainer_epoch_bench.py)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "trainer_epoch_bench"))
    args = ap.parse_args()

    from ast_tpu.train import trainer as trainer_mod
    from ast_tpu.train.trainer import NN

    nn = NN(args.root + "/exp")
    n_utts = 17306

    stats = {}

    def wrap(fn, key):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            stats[key][0] += time.perf_counter() - t0
            stats[key][1] += 1
            return out
        return timed

    nn._train_multi_step = wrap(nn._train_multi_step, "multi")
    nn._train_step = wrap(nn._train_step, "single")

    orig_iter = trainer_mod.Prefetcher.__iter__

    def timed_iter(self):
        it = orig_iter(self)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            stats["prefetch"][0] += time.perf_counter() - t0
            stats["prefetch"][1] += 1
            yield item

    trainer_mod.Prefetcher.__iter__ = timed_iter

    for e in range(1, args.epochs + 1):
        for k in ("multi", "single", "prefetch"):
            stats[k] = [0.0, 0]
        t0 = time.perf_counter()
        nn.train_epoch("syn_train", epoch=e)
        dt = time.perf_counter() - t0
        issue = stats["multi"][0] + stats["single"][0]
        wait = stats["prefetch"][0]
        print(f"epoch {e}: {dt:7.2f}s  {n_utts / dt:7.1f} utts/s | "
              f"dispatch_issue {issue:6.2f}s "
              f"({stats['multi'][1]}m+{stats['single'][1]}s calls), "
              f"prefetch_wait {wait:6.2f}s "
              f"({stats['prefetch'][1]} gets), "
              f"other {dt - issue - wait:6.2f}s"
              + ("  [cold]" if e == 1 else ""), flush=True)


if __name__ == "__main__":
    main()
