#!/usr/bin/env python
"""End-to-end learnability check: a synthetic *transcribable* corpus.

Each vocab token has a fixed 8-frame spectral signature; an utterance's
"speech" is the concatenation of its tokens' signatures plus noise, so a
correct implementation must drive dev BLEU toward 100 within a few
epochs.  This validates the full stack — dataloader, model, trainer,
greedy decode, detokenization, BLEU — as one system, far beyond unit
tests.  Usage: python scripts/synthetic_train.py [--epochs 8]
"""

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_corpus(root, n_train=600, n_dev=60, vocab_words=30, seed=0,
                 extras=None):
    rng = np.random.RandomState(seed)
    exp = os.path.join(root, "exp")
    data = os.path.join(root, "data")
    speech = os.path.join(root, "speech")
    refs = os.path.join(data, "refs")
    os.makedirs(exp, exist_ok=True)
    os.makedirs(data, exist_ok=True)

    words = [f"w{i}".encode() for i in range(vocab_words)]
    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]
    w2i = {w: i for i, w in enumerate(specials + words)}
    vocab = {"en_w": {"w2i": w2i,
                      "i2w": {i: w for w, i in w2i.items()},
                      "freq": {}}}

    # fixed spectral signature per word: 8 frames x 13 dims
    signatures = rng.randn(vocab_words, 8, 13).astype(np.float32) * 2.0

    sets = {"syn_train": n_train, "syn_dev": n_dev}
    map_dict, info = {}, {}
    for set_key, n in sets.items():
        map_dict[set_key] = {}
        info[set_key] = {}
        os.makedirs(os.path.join(speech, set_key), exist_ok=True)
        for i in range(n):
            utt = f"{set_key}_u{i:04d}"
            n_words = int(rng.randint(2, 9))
            idx = rng.randint(vocab_words, size=n_words)
            toks = [words[j] for j in idx]
            feats = np.concatenate([signatures[j] for j in idx], axis=0)
            feats = feats + 0.1 * rng.randn(*feats.shape).astype(np.float32)
            np.save(os.path.join(speech, set_key, f"{utt}.npy"), feats)
            map_dict[set_key][utt] = {"en_w": toks}
            info[set_key][utt] = {"sp": len(feats), "en_w": n_words}

    for name, obj in [("syn.vocab", vocab), ("syn.map", map_dict),
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
                             for w in map_dict["syn_dev"][u]["en_w"]) + "\n")

    model_cfg = {
        "dropout": {"embed": 0.1, "rnn": 0.1, "out": 0},
        "rnn_config": {
            "bi_rnn": True, "enc_layers": 2, "dec_layers": 2,
            "hidden_units": 256, "embedding_units": 128, "attn_units": 256,
            "n_attn": 1, "feed_attn": True, "ln": False,
        },
        "cnn_config": {
            "bn": True,
            "cnn_layers": [
                {"in_channels": None, "out_channels": 64, "ksize": [5, 13],
                 "stride": [2, 13], "pad": [2, 0]},
                {"in_channels": None, "out_channels": 256, "ksize": [5, 1],
                 "stride": [2, 1], "pad": [2, 0]},
            ],
        },
    }
    train_cfg = {
        "seed": "syn-seed",
        "iters_save": 50,
        "train_set": "syn_train",
        "dev_set": "syn_dev",
        "extras": dict({"random_out": 0, "speech_noise": 0.05,
                        "teach_ratio": 0.9,
                        "compute_dtype": "bfloat16"}, **(extras or {})),
        "data": {
            "enc_key": "sp", "dec_key": "en_w",
            "speech_path": speech,
            "map_path": os.path.join(data, "syn.map"),
            "vocab_path": os.path.join(data, "syn.vocab"),
            "info_path": os.path.join(data, "syn.info"),
            "max_pred": 16,
            "refs_path": refs,
            "n_evals": 1,
            "buckets_num": 4, "buckets_width": 24,
            "train_scale": 1, "zero_input": 0.05,
            "target_pad_multiple": 8,
        },
        "optimizer": {"type": 0, "lr": 0.001, "l2": 0.0001,
                      "grad_clip": 2, "grad_noise_eta": 0, "freeze": []},
        "batch_size": 32,
    }
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(model_cfg, f)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    return exp


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--root", default=None)
    parser.add_argument("--steps-per-dispatch", type=int, default=1)
    args = parser.parse_args()

    root = args.root or tempfile.mkdtemp(prefix="syn_ast_")
    exp = build_corpus(
        root, extras={"steps_per_dispatch": args.steps_per_dispatch})
    print(f"synthetic corpus at {root}", flush=True)

    import ast_tpu.cli.train as train_cli
    train_cli.main(["-m", exp, "-e", str(args.epochs)])

    with open(os.path.join(exp, "dev.log")) as f:
        rows = [line.strip().split(", ") for line in f]
    bleus = [float(b) for _, b in rows]
    print("dev BLEU per epoch:", bleus, flush=True)
    assert bleus[-1] > 50, f"model failed to learn: BLEU {bleus[-1]}"
    print("LEARNABILITY CHECK PASSED", flush=True)


if __name__ == "__main__":
    main()
