#!/usr/bin/env python
"""Flagship-scale convergence A/B: the real ~26M-param es_en_20h model
config trained through the shipped ``train.py`` CLI on a learnable
synthetic corpus — bf16 compute (the recommended configuration)
against float32.

Every earlier convergence demonstration ran tiny/small models; this
drives the committed ``experiments/es_en_20h/model_cfg.json`` (reference
model shape, seq2seq.py:30-80; training shape train.py:48-76) at full
size so bf16 training QUALITY at flagship scale is measured, not
inferred.  Each of the 1094 vocab words has a fixed 8-frame spectral
signature; utterances are signature concatenations + noise, so a
correct training stack must drive dev BLEU high within tens of epochs.

Both arms share the corpus and the config seed => identical
deterministic batch streams and dropout keys; the ONLY difference is
the compute dtype (bf16 vs f32).

Usage:
  python scripts/flagship_convergence.py [--epochs 25] [--n-train 4000]
      [--root DIR] [--arm bf16|f32|both]
"""

import argparse
import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB_WORDS = 1094  # + 4 specials = the flagship's 1098


def build_corpus(root, n_train, n_dev, seed=0, log=print):
    rng = np.random.RandomState(seed)
    data = os.path.join(root, "data")
    speech = os.path.join(root, "speech")
    refs = os.path.join(data, "refs")
    os.makedirs(data, exist_ok=True)

    words = [f"w{i}".encode() for i in range(VOCAB_WORDS)]
    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]
    w2i = {w: i for i, w in enumerate(specials + words)}
    vocab = {"en_w": {"w2i": w2i,
                      "i2w": {i: w for w, i in w2i.items()},
                      "freq": {}}}

    # 8 frames/word -> 2 post-CNN encoder frames per word at the
    # flagship's 4x time downsampling
    signatures = rng.randn(VOCAB_WORDS, 8, 13).astype(np.float32) * 2.0

    done = os.path.join(root, ".corpus_done")
    regen = not os.path.exists(done)
    sets = {"conv_train": n_train, "conv_dev": n_dev}
    map_dict, info = {}, {}
    t0 = time.time()
    for set_key, n in sets.items():
        map_dict[set_key] = {}
        info[set_key] = {}
        os.makedirs(os.path.join(speech, set_key), exist_ok=True)
        for i in range(n):
            utt = f"{set_key}_u{i:05d}"
            n_words = int(rng.randint(6, 30))
            idx = rng.randint(VOCAB_WORDS, size=n_words)
            toks = [words[j] for j in idx]
            feats = np.concatenate([signatures[j] for j in idx], axis=0)
            feats = feats + 0.1 * rng.randn(*feats.shape).astype(
                np.float32)
            if regen:
                np.save(os.path.join(speech, set_key, f"{utt}.npy"),
                        feats)
            map_dict[set_key][utt] = {"en_w": toks}
            info[set_key][utt] = {"sp": len(feats), "en_w": n_words}
    if regen:
        log(f"corpus: {n_train}+{n_dev} utts generated in "
            f"{time.time() - t0:.0f}s")
        open(done, "w").write("ok")

    for name, obj in [("conv.vocab", vocab), ("conv.map", map_dict),
                      ("conv.info", info)]:
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)
    dev_refs = os.path.join(refs, "conv_dev")
    os.makedirs(dev_refs, exist_ok=True)
    dev_utts = sorted(map_dict["conv_dev"])
    with open(os.path.join(dev_refs, "eval.ids"), "w") as f:
        f.write("\n".join(dev_utts) + "\n")
    with open(os.path.join(dev_refs, "ref.en0"), "w") as f:
        for u in dev_utts:
            f.write(" ".join(w.decode()
                             for w in map_dict["conv_dev"][u]["en_w"])
                    + "\n")


def write_arm(root, arm):
    """Experiment dir for one arm; the flagship model_cfg verbatim, only
    the compute dtype differing."""
    exp = os.path.join(root, f"exp_{arm}")
    os.makedirs(exp, exist_ok=True)
    data = os.path.join(root, "data")
    with open(os.path.join(REPO, "experiments", "es_en_20h",
                           "model_cfg.json")) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"].pop("dec_vocab_size", None)
    train_cfg = {
        # shared seed => both arms see identical batch streams
        "seed": "flagship-conv",
        "iters_save": 1000,
        "train_set": "conv_train",
        "dev_set": "conv_dev",
        # the es_en_20h training shape (reference:
        # experiments/es_en_20h/train_cfg.json)
        "extras": {"random_out": 0, "speech_noise": 0.25,
                   "teach_ratio": 0.8,
                   "compute_dtype": ("bfloat16" if arm == "bf16"
                                     else "float32"),
                   # bit-identical feeding, ~100x less wire traffic
                   "hbm_cache": True},
        "data": {
            "enc_key": "sp", "dec_key": "en_w",
            "speech_path": os.path.join(root, "speech"),
            "map_path": os.path.join(data, "conv.map"),
            "vocab_path": os.path.join(data, "conv.vocab"),
            "info_path": os.path.join(data, "conv.info"),
            "refs_path": os.path.join(data, "refs"),
            "max_pred": 48, "n_evals": 1,
            # 6-29 words x 8 frames = 48-232 frames -> buckets 0-5
            "buckets_num": 6, "buckets_width": 40,
            "train_scale": 1, "zero_input": 0.1,
        },
        "optimizer": {"type": 0, "lr": 1e-3, "l2": 1e-4,
                      "grad_clip": 2, "grad_noise_eta": 0,
                      "freeze": []},
        "batch_size": 32,
    }
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f, indent=1)
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(mcfg, f, indent=1)
    return exp


def read_logs(exp):
    def rows(path):
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [line.strip().split(", ") for line in f if line.strip()]
    losses = [float(v) for _, v in rows(os.path.join(exp, "train.log"))]
    bleus = [float(v) for _, v in rows(os.path.join(exp, "dev.log"))]
    return losses, bleus


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-dev", type=int, default=400)
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "flagship_conv"))
    ap.add_argument("--arm", default="both",
                    choices=["bf16", "f32", "both"])
    args = ap.parse_args()

    build_corpus(args.root, args.n_train, args.n_dev)
    arms = (["bf16", "f32"] if args.arm == "both"
            else [args.arm])

    import ast_tpu.cli.train as train_cli
    results = {}
    for arm in arms:
        exp = write_arm(args.root, arm)
        print(f"=== arm {arm}: {exp} ===", flush=True)
        t0 = time.time()
        train_cli.main(["-m", exp, "-e", str(args.epochs)])
        losses, bleus = read_logs(exp)
        results[arm] = (losses, bleus)
        print(f"arm {arm}: {time.time() - t0:.0f}s  "
              f"final loss {losses[-1]:.3f}  final BLEU {bleus[-1]:.1f}",
              flush=True)

    print("\n=== summary ===")
    for arm, (losses, bleus) in results.items():
        print(f"{arm:10s} loss: "
              + " ".join(f"{v:.2f}" for v in losses))
        print(f"{arm:10s} BLEU: "
              + " ".join(f"{v:.1f}" for v in bleus))

    if len(results) == 2:
        lf, bf = results["bf16"]
        ls, bs = results["f32"]
        n = min(len(lf), len(ls))
        rel = [abs(a - b) / max(abs(b), 1e-6)
               for a, b in zip(lf[:n], ls[:n])]
        print(f"loss-curve max relative divergence over {n} epochs: "
              f"{max(rel):.3f}")
        assert bf[-1] > 60, f"bf16 arm failed to learn: {bf[-1]}"
        # The task has a sharp takeoff, and rounding moves the
        # breakthrough epoch between arms; the claim under test is that
        # bf16 training QUALITY is not degraded, i.e. both arms reach
        # criterion and bf16 is not the late one.  Extend the f32 arm
        # past the matched-epoch budget if its takeoff is still in
        # progress.
        extra = 0
        while bs[-1] <= 60 and extra < args.epochs:
            extra += 5
            exp = os.path.join(args.root, "exp_f32")
            print(f"extending f32 arm to epoch "
                  f"{args.epochs + extra} (BLEU {bs[-1]:.1f})",
                  flush=True)
            train_cli.main(["-m", exp, "-e", "5"])
            ls, bs = read_logs(exp)
        results["f32"] = (ls, bs)

        def epochs_to(bleus, thr=50):
            return next((i + 1 for i, v in enumerate(bleus) if v > thr),
                        None)

        ef, es = epochs_to(bf), epochs_to(bs)
        print(f"epochs to dev BLEU>50: bf16 {ef}  f32 {es}")
        print(f"final: bf16 {bf[-1]:.1f} ({len(bf)} epochs)  "
              f"f32 {bs[-1]:.1f} ({len(bs)} epochs)")
        assert bs[-1] > 60, \
            f"f32 arm failed to reach criterion: {bs[-1]}"
        assert ef is not None and (es is None or ef <= es + 2), \
            "bf16 arm took off materially later than f32"
        print("FLAGSHIP CONVERGENCE A/B PASSED", flush=True)
    elif results:
        (losses, bleus), = results.values()
        assert bleus[-1] > 60, f"failed to learn: {bleus[-1]}"


if __name__ == "__main__":
    main()
