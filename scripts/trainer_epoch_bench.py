#!/usr/bin/env python
"""Time the REAL trainer (NN.train_epoch) at flagship scale.

bench.py --epoch replays the trainer's dispatch plan with hand-built
jitted steps; this script drives the shipped harness itself —
dataloader (per-utt .npy or mmap feature pack), prefetcher, per-bucket
jitted steps, multi-step dispatch, snapshot cadence, loss bookkeeping —
over a synthetic corpus shaped exactly like the es_en_20h epoch
(bench.EPOCH_BUCKETS: same per-bucket utterance counts, frame lengths,
and target lengths), so the two numbers are directly comparable.

Usage:
  python scripts/trainer_epoch_bench.py [--batch 32] [--g 4]
      [--epochs 3] [--root DIR] [--pack] [--keep]

Writes/loads the corpus under --root (default
<checkout>/.bench_data/trainer_epoch_bench; ~350 MB of features, reused
across runs).  Prints per-epoch wall time
and real-utts/sec through NN.train_epoch, then the bench.py epoch-model
number from the same process for reconciliation.
"""

import argparse
import json
import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

VOCAB_WORDS = 1094  # + 4 specials = the flagship's 1098
DEFAULT_ROOT = os.path.join(REPO, ".bench_data", "trainer_epoch_bench")


def build_corpus(root, log=print, scale=1, buckets=None,
                 utts_per_bucket=None):
    """Synthetic corpus matching bench.EPOCH_BUCKETS exactly.

    ``scale``: multiply every bucket's utterance count (scale=8 ==
    the 160h corpus shape — fisher_20h.info x8, ~138k utts / ~2.9 GB
    of features).  ``buckets``: keep only these bucket ids;
    ``utts_per_bucket``: replace each kept bucket's count (a cut-down
    corpus with the same per-bucket shapes).  Target words follow a
    Zipf(1) law over the vocabulary, as text does, so a model can learn
    from the first steps.  Features and targets come from a fixed seed."""
    import bench

    data = os.path.join(root, "data")
    speech = os.path.join(root, "speech", "syn_train")
    refs = os.path.join(data, "refs")
    exp = os.path.join(root, "exp")
    done_marker = os.path.join(root, ".corpus_done")
    for d in (data, speech, refs, exp):
        os.makedirs(d, exist_ok=True)

    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]
    words = [f"w{i}".encode() for i in range(VOCAB_WORDS)]
    w2i = {w: i for i, w in enumerate(specials + words)}
    vocab = {"en_w": {"w2i": w2i,
                      "i2w": {i: w for w, i in w2i.items()},
                      "freq": {}}}

    rng = np.random.RandomState(0)
    map_dict = {"syn_train": {}, "syn_dev": {}}
    info = {"syn_train": {}, "syn_dev": {}}

    # the marker records which corpus the features on disk belong to
    # (the trailing 2 is the generator's version: frames now stay below
    # each bucket's padded length T)
    signature = json.dumps([scale, buckets, utts_per_bucket, 2])
    regen = not (os.path.exists(done_marker)
                 and open(done_marker).read() == signature)
    zipf = 1.0 / np.arange(1, VOCAB_WORDS + 1)
    zipf /= zipf.sum()
    t0 = time.time()
    n_total = 0
    for b, n, T, U in bench.EPOCH_BUCKETS:
        if buckets is not None and b not in buckets:
            continue
        n = utts_per_bucket or n * int(scale)
        # frames in (b*80, T): duration bucket b holds frames
        # [b*80, (b+1)*80) and pads them to T = (b+1)*80
        lo, hi = b * 80 + 1, T - 1
        for i in range(n):
            utt = f"b{b:02d}_u{i:05d}"
            frames = int(rng.randint(max(lo, hi - 79), hi + 1))
            # targets: U includes GO/EOS + pad-to-multiple headroom; use
            # U-8..U-2 real tokens so per-bucket target_len lands at U
            n_words = int(rng.randint(max(2, U - 8), U - 1))
            toks = [words[i] for i in rng.choice(VOCAB_WORDS, n_words,
                                                 p=zipf)]
            map_dict["syn_train"][utt] = {"en_w": toks}
            info["syn_train"][utt] = {"sp": frames, "en_w": n_words}
            if regen:
                feats = rng.randn(frames, 13).astype(np.float32)
                np.save(os.path.join(speech, f"{utt}.npy"), feats)
            n_total += 1
    # minimal dev set (never timed; keeps NN construction happy)
    dev_dir = os.path.join(root, "speech", "syn_dev")
    os.makedirs(dev_dir, exist_ok=True)
    for i in range(8):
        utt = f"dev_u{i:03d}"
        frames = 100 + 10 * i
        map_dict["syn_dev"][utt] = {"en_w": [words[i]]}
        info["syn_dev"][utt] = {"sp": frames, "en_w": 1}
        if regen:
            np.save(os.path.join(dev_dir, f"{utt}.npy"),
                    rng.randn(frames, 13).astype(np.float32))
    if regen:
        log(f"generated {n_total} feature files in "
            f"{time.time() - t0:.0f}s")
        with open(done_marker, "w") as f:
            f.write(signature)

    for name, obj in [("syn.map", map_dict), ("syn.vocab", vocab),
                      ("syn.info", info)]:
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)
    dev_refs = os.path.join(refs, "syn_dev")
    os.makedirs(dev_refs, exist_ok=True)
    dev_utts = sorted(map_dict["syn_dev"])
    with open(os.path.join(dev_refs, "eval.ids"), "w") as f:
        f.write("\n".join(dev_utts) + "\n")
    with open(os.path.join(dev_refs, "ref.en0"), "w") as f:
        for u in dev_utts:
            f.write(" ".join(w.decode()
                             for w in map_dict["syn_dev"][u]["en_w"])
                    + "\n")
    return n_total


def write_configs(root, batch, g, transfer_dtype="float32",
                  prefetch_workers=2, hbm_cache=False,
                  hbm_cache_dtype="float32", mcfg=None, exp_name="exp"):
    """Write ``train_cfg.json`` + ``model_cfg.json`` for the corpus under
    ``root`` into ``root/<exp_name>``; ``mcfg`` defaults to the flagship
    model."""
    from __graft_entry__ import FLAGSHIP_MCFG

    exp = os.path.join(root, exp_name)
    os.makedirs(exp, exist_ok=True)
    data = os.path.join(root, "data")
    train_cfg = {
        "seed": "epoch-bench",
        "iters_save": 1000,       # no in-epoch snapshots in the timing
        "train_set": "syn_train",
        "dev_set": "syn_dev",
        "extras": {"random_out": 0, "speech_noise": 0.25,
                   "teach_ratio": 0.8,
                   "compute_dtype": "bfloat16",
                   "transfer_dtype": transfer_dtype,
                   "prefetch_workers": prefetch_workers,
                   "hbm_cache": hbm_cache,
                   "hbm_cache_dtype": hbm_cache_dtype,
                   "steps_per_dispatch": g},
        "data": {
            "enc_key": "sp", "dec_key": "en_w",
            "speech_path": os.path.join(root, "speech"),
            "map_path": os.path.join(data, "syn.map"),
            "vocab_path": os.path.join(data, "syn.vocab"),
            "info_path": os.path.join(data, "syn.info"),
            "refs_path": os.path.join(data, "refs"),
            "max_pred": 96, "n_evals": 1,
            "buckets_num": 20, "buckets_width": 80,
            "train_scale": 1, "zero_input": 0,
        },
        "optimizer": {"type": 0, "lr": 1e-3, "l2": 1e-4,
                      "grad_clip": 2, "grad_noise_eta": 0,
                      "freeze": []},
        "batch_size": batch,
    }
    mcfg = json.loads(json.dumps(mcfg or FLAGSHIP_MCFG))
    mcfg["rnn_config"].pop("dec_vocab_size", None)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f, indent=1)
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(mcfg, f, indent=1)
    return exp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--g", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--pack", action="store_true",
                    help="serve features from an mmap pack instead of "
                         "per-utt .npy files")
    ap.add_argument("--transfer-dtype", default="float32",
                    dest="transfer_dtype",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--workers", type=int, default=2,
                    help="extras.prefetch_workers")
    ap.add_argument("--hbm-cache", action="store_true",
                    dest="hbm_cache",
                    help="extras.hbm_cache: device-resident epoch "
                         "feature cache (gather-assembled batches)")
    ap.add_argument("--hbm-cache-dtype", default="float32",
                    dest="hbm_cache_dtype",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--scale", type=int, default=1,
                    help="multiply bucket utterance counts (8 = the "
                         "160h corpus shape)")
    ap.add_argument("--skip-model", action="store_true",
                    help="skip the bench.py epoch-model comparison run")
    args = ap.parse_args()

    n_utts = build_corpus(args.root, scale=args.scale)
    if args.pack:
        from ast_tpu.data.feature_pack import pack_features
        for s in ("syn_train", "syn_dev"):
            d = os.path.join(args.root, "speech", s)
            out = os.path.join(args.root, "speech", f"{s}.pack")
            if not os.path.exists(out):
                pack_features(d, out)
                print(f"packed {s}")
    exp = write_configs(args.root, args.batch, args.g,
                        transfer_dtype=args.transfer_dtype,
                        prefetch_workers=args.workers,
                        hbm_cache=args.hbm_cache,
                        hbm_cache_dtype=args.hbm_cache_dtype)
    print(f"transfer_dtype={args.transfer_dtype} "
          f"prefetch_workers={args.workers} "
          f"hbm_cache={args.hbm_cache}"
          + (f" ({args.hbm_cache_dtype})" if args.hbm_cache else ""),
          flush=True)

    import jax
    from ast_tpu.train.trainer import NN
    print(f"backend={jax.default_backend()} B={args.batch} "
          f"G={args.g} utts/epoch={n_utts}", flush=True)
    nn = NN(exp)
    results = []
    for e in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        loss = nn.train_epoch("syn_train", epoch=e)
        dt = time.perf_counter() - t0
        ups = n_utts / dt
        results.append(ups)
        print(f"epoch {e}: {dt:7.2f}s  {ups:8.1f} real utts/sec "
              f"(loss {loss:.3f})"
              + ("  [cold: compiles + feature-cache fill]"
                 if e == 1 else ""), flush=True)

    best = max(results[1:]) if len(results) > 1 else results[0]
    print(f"\nNN.train_epoch warm best: {best:.1f} real utts/sec")

    if not args.skip_model:
        import bench
        dt, ups, _ = bench.bench_epoch(B=args.batch, G=args.g)
        print(f"bench.py epoch model:     {ups:.1f} real utts/sec "
              f"({dt:.2f}s/epoch)")
        print(f"harness/model ratio:      {best / ups:.3f}")


if __name__ == "__main__":
    main()
