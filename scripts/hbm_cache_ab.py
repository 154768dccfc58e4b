#!/usr/bin/env python
"""Same-session A/B: NN.train_epoch with the HBM feature cache vs host
feeding, flagship scale (the es_en_20h-shaped epoch corpus of
trainer_epoch_bench).

Epochs strictly alternate between the two NN instances inside ONE
process so drifts of the device's speed hit both arms alike; the host
arm ships features in bf16 (``transfer_dtype``).  Reports
per-arm epoch times, medians, and paired ratios.

Usage: python scripts/hbm_cache_ab.py [--rounds 5] [--batch 32] [--g 4]
"""

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from trainer_epoch_bench import build_corpus, write_configs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--g", type=int, default=4)
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "trainer_epoch_bench"))
    args = ap.parse_args()

    n_utts = build_corpus(args.root)

    # two experiment dirs so checkpoints/logs stay separate
    exp_cache = write_configs(args.root, args.batch, args.g,
                              hbm_cache=True)
    cache_dir = exp_cache + "_cache"
    if os.path.exists(cache_dir):
        shutil.rmtree(cache_dir)
    shutil.copytree(exp_cache, cache_dir)
    exp_host = write_configs(args.root, args.batch, args.g,
                             transfer_dtype="bfloat16")

    import jax
    from ast_tpu.train.trainer import NN
    print(f"backend={jax.default_backend()} B={args.batch} G={args.g} "
          f"utts={n_utts}", flush=True)

    nn_cache = NN(cache_dir)
    nn_host = NN(exp_host)
    times = {"cache": [], "host": []}
    t0 = time.time()
    for r in range(1, args.rounds + 1):
        for name, nn in (("cache", nn_cache), ("host", nn_host)):
            ta = time.perf_counter()
            loss = nn.train_epoch("syn_train", epoch=r)
            dt = time.perf_counter() - ta
            times[name].append(dt)
            print(f"round {r} {name:5s}: {dt:8.2f}s "
                  f"{n_utts / dt:8.1f} utts/s (loss {loss:.3f})"
                  + ("  [cold]" if r == 1 else ""), flush=True)

    warm = {k: v[1:] if len(v) > 1 else v for k, v in times.items()}
    med = {k: float(np.median(v)) for k, v in warm.items()}
    best = {k: min(v) for k, v in warm.items()}
    print(f"\ntotal {time.time() - t0:.0f}s")
    for k in ("cache", "host"):
        print(f"{k:5s}: median {med[k]:.2f}s ({n_utts / med[k]:.0f} "
              f"utts/s)  best {best[k]:.2f}s ({n_utts / best[k]:.0f})")
    pairs = [h / c for c, h in zip(warm["cache"], warm["host"])]
    print("paired host/cache epoch-time ratios: "
          + " ".join(f"{r:.2f}" for r in pairs))
    print(f"median speedup: {med['host'] / med['cache']:.2f}x")


if __name__ == "__main__":
    main()
