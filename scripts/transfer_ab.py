#!/usr/bin/env python
"""Pretraining-transfer A/B: the reference's scientific claim, end to end.

The reference exists to show that *pre-training on ASR improves
low-resource speech translation* (arXiv:1809.01431; workflow:
train.py on an ASR experiment -> copy_params.py -> train.py on the ST
experiment, reference copy_params.py:26-68).  This script reproduces
that claim through the real ast_tpu CLIs on a synthetic transcribable
corpus:

  1. ASR pretraining: plentiful utterances (default 600), targets are
     the source words themselves.
  2. Low-resource ST: few utterances (default 48) over the SAME
     acoustic signatures, targets are a permuted "translation" vocab,
     so the encoder's learned acoustics transfer but the decoder must
     be learned fresh.
  3. Arm A trains ST from scratch; arm B first runs
     `copy_params --groups enc,attn` from the ASR checkpoint (saved as
     epoch 0, auto-resumed) and trains the same number of epochs with
     the identical seed/data stream.

A correct framework must show arm B dominating arm A's dev BLEU
trajectory, exactly like the paper's Figure 2.  Tiny shapes: the demo
is CPU-sized (on an accelerator the per-bucket compiles would dwarf the
arithmetic), so it runs on the CPU unless ``JAX_PLATFORMS`` names
another platform.

Measured on the CPU backend (defaults, ~20 min): ASR
pretraining reaches dev BLEU 93-97 by epoch 12; the from-scratch ST
arm crawls to ~5-10 BLEU over 25 epochs while the transferred arm
takes off at epoch ~6 and reaches 70-92 (final 91.8 vs 9.9) — the
paper's low-resource transfer curve, reproduced end to end (trajectory
table in docs/PARITY.md).

Task-size calibration (measured): the ST corpus must be large enough
that exploiting the transferred acoustics beats memorizing the target
sequences — at 48 utterances BOTH arms drive train loss to ~0 by pure
decoder memorization and dev BLEU stays ~2 (even with the encoder
frozen at its pretrained weights), at 96 the acoustic route wins and
the transfer signal is dramatic, and by 160 the scratch arm starts
learning the acoustics itself (still dominated, but the final margin
narrows).  The default is 96.

Usage: python scripts/transfer_ab.py [--asr-epochs 12] [--st-epochs 25]
"""

import argparse
import json
import os
import pickle
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the demo is CPU-sized: the CPU unless the caller names a platform
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def _write_exp(root, name, sets, map_dict, info, vocab, speech, refs,
               dev_set, seed):
    """One experiment dir + its data pickles in the reference layout."""
    exp = os.path.join(root, name)
    data = os.path.join(root, "data_" + name)
    os.makedirs(exp, exist_ok=True)
    os.makedirs(data, exist_ok=True)
    for fname, obj in [("syn.vocab", vocab), ("syn.map", map_dict),
                       ("syn.info", info)]:
        with open(os.path.join(data, fname), "wb") as f:
            pickle.dump(obj, f)

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
        "seed": seed,
        "iters_save": 50,
        "train_set": [k for k in sets if k.endswith("train")][0],
        "dev_set": dev_set,
        # f32: this CPU XLA build has no bf16 dot (accelerator configs use bf16)
        "extras": {"random_out": 0, "speech_noise": 0.05,
                   "teach_ratio": 0.9, "compute_dtype": "float32"},
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
        "batch_size": 16,
    }
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(model_cfg, f)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    return exp


def build_tasks(root, n_asr=600, n_st=48, n_dev=50, vocab_words=30, seed=0):
    """Shared acoustic signatures; ASR transcribes, ST 'translates'."""
    rng = np.random.RandomState(seed)
    speech = os.path.join(root, "speech")
    refs = os.path.join(root, "refs")
    os.makedirs(speech, exist_ok=True)

    src_words = [f"w{i}".encode() for i in range(vocab_words)]
    tgt_words = [f"t{i}".encode() for i in range(vocab_words)]
    perm = rng.permutation(vocab_words)
    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]

    def make_vocab(words):
        w2i = {w: i for i, w in enumerate(specials + words)}
        return {"en_w": {"w2i": w2i,
                         "i2w": {i: w for w, i in w2i.items()},
                         "freq": {}}}

    # fixed spectral signature per source word: 8 frames x 13 dims
    signatures = rng.randn(vocab_words, 8, 13).astype(np.float32) * 2.0

    def make_corpus(prefix, sets, translate):
        map_dict, info = {}, {}
        for set_key, n in sets.items():
            map_dict[set_key] = {}
            info[set_key] = {}
            os.makedirs(os.path.join(speech, set_key), exist_ok=True)
            for i in range(n):
                utt = f"{set_key}_u{i:04d}"
                # 6-14 words: sentences long enough that 4-gram BLEU is
                # signal, not smoothing noise
                n_words = int(rng.randint(6, 15))
                idx = rng.randint(vocab_words, size=n_words)
                if translate:
                    toks = [tgt_words[perm[j]] for j in idx]
                else:
                    toks = [src_words[j] for j in idx]
                feats = np.concatenate(
                    [signatures[j] for j in idx], axis=0)
                # noisy acoustics: 48 ST utts are too few to learn the
                # signatures from scratch, 600 ASR utts are plenty
                feats = feats + 0.25 * rng.randn(
                    *feats.shape).astype(np.float32)
                np.save(os.path.join(speech, set_key, f"{utt}.npy"), feats)
                map_dict[set_key][utt] = {"en_w": toks}
                info[set_key][utt] = {"sp": len(feats), "en_w": n_words}
        return map_dict, info

    def write_refs(set_key, map_dict):
        d = os.path.join(refs, set_key)
        os.makedirs(d, exist_ok=True)
        utts = sorted(map_dict[set_key])
        with open(os.path.join(d, "eval.ids"), "w") as f:
            f.write("\n".join(utts) + "\n")
        with open(os.path.join(d, "ref.en0"), "w") as f:
            for u in utts:
                f.write(" ".join(
                    w.decode() for w in map_dict[set_key][u]["en_w"]) + "\n")

    asr_sets = {"asr_train": n_asr, "asr_dev": n_dev}
    asr_map, asr_info = make_corpus("asr", asr_sets, translate=False)
    write_refs("asr_dev", asr_map)
    asr_exp = _write_exp(root, "asr", asr_sets, asr_map, asr_info,
                         make_vocab(src_words), speech, refs, "asr_dev",
                         seed="transfer-ab-asr")

    st_sets = {"st_train": n_st, "st_dev": n_dev}
    st_map, st_info = make_corpus("st", st_sets, translate=True)
    write_refs("st_dev", st_map)
    st_exps = {}
    for arm in ("st_scratch", "st_transfer"):
        st_exps[arm] = _write_exp(root, arm, st_sets, st_map, st_info,
                                  make_vocab(tgt_words), speech, refs,
                                  "st_dev", seed="transfer-ab-st")
    return asr_exp, st_exps


def read_bleus(exp):
    with open(os.path.join(exp, "dev.log")) as f:
        return [float(line.strip().split(", ")[1]) for line in f]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--asr-epochs", type=int, default=12)
    parser.add_argument("--st-epochs", type=int, default=25)
    parser.add_argument("--st-utts", type=int, default=96)
    parser.add_argument("--root", default=None)
    args = parser.parse_args()

    root = args.root or tempfile.mkdtemp(prefix="transfer_ab_")
    asr_exp, st_exps = build_tasks(root, n_st=args.st_utts)
    print(f"synthetic tasks at {root}", flush=True)

    import ast_tpu.cli.copy_params as copy_cli
    import ast_tpu.cli.train as train_cli

    print("=== ASR pretraining ===", flush=True)
    train_cli.main(["-m", asr_exp, "-e", str(args.asr_epochs)])
    print("ASR dev BLEU:", read_bleus(asr_exp), flush=True)

    print("=== ST arm A: from scratch ===", flush=True)
    train_cli.main(["-m", st_exps["st_scratch"], "-e", str(args.st_epochs)])

    print("=== ST arm B: transfer enc,attn then train ===", flush=True)
    copy_cli.main(["--src", asr_exp, "--dst", st_exps["st_transfer"],
                   "--groups", "enc,attn"])
    train_cli.main(["-m", st_exps["st_transfer"], "-e", str(args.st_epochs)])

    scratch = read_bleus(st_exps["st_scratch"])
    transfer = read_bleus(st_exps["st_transfer"])
    print("\nepoch | scratch BLEU | transfer BLEU")
    for i, (a, b) in enumerate(zip(scratch, transfer)):
        print(f"{i + 1:5d} | {a:12.2f} | {b:13.2f}")
    print(f"\nfinal: scratch {scratch[-1]:.2f}  "
          f"transfer {transfer[-1]:.2f}", flush=True)
    # at the default budget the separation is dramatic (scratch ~10 vs
    # transfer ~92); a weak margin means the transfer machinery is
    # broken even if it nominally "wins".  Below ~15 epochs the transfer
    # arm may not have hit its takeoff (epoch ~6-8 on defaults) and both
    # arms sit in single-digit noise, so a pass/fail verdict is
    # meaningless — report the trajectories and say so instead of
    # asserting on noise.
    if args.st_epochs < 15:
        print("note: --st-epochs < 15 is below the transfer takeoff; "
              "trajectories reported without a pass/fail verdict "
              "(the A/B claim is defined at the default 25-epoch budget)",
              flush=True)
        return
    margin = 20.0
    assert transfer[-1] > scratch[-1] + margin, (
        "pretraining transfer failed to beat from-scratch: "
        f"final {transfer[-1]} vs {scratch[-1]} (margin {margin})")
    assert max(transfer) > max(scratch) + margin, (
        "pretraining transfer failed to beat from-scratch: "
        f"best {max(transfer)} vs {max(scratch)} (margin {margin})")
    print("TRANSFER A/B PASSED: pretrained encoder beats scratch",
          flush=True)


if __name__ == "__main__":
    main()
